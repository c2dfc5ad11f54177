"""Arbitrary-track ingestion: fit recorded X/Y centerlines into ``Track`` tables.

The reference's native MPCC stack consumes *measured* centerlines rather than
analytic segment specs: it removes irregularly-spaced outlier points, fits
parametric cubic splines x(s), y(s), re-parameterises them by arc length with
two successive fit/resample passes, and projects states onto the spline with a
Newton iteration (``Matlab-tests/MPCC-master/C++/Spline/arc_length_spline.h:40-52``,
``arc_length_spline.cpp`` outlierRemoval/fitSpline/porjectOnSpline, JSON track
loader ``Params/track.cpp``). This module reproduces that capability on-device first:
the fit runs once on host (float64 numpy/scipy), then emits the same flat
per-segment ``Track`` table every other geometry op in this framework already
consumes — so LPV/NL/MPCC planners race measured tracks with zero new device
code, and queries stay gathers over a table instead of spline evaluations.

Within a fine segment the path is modelled with constant curvature (the
segment-table contract); with the default 1000 resampled segments the
centerline reconstruction error is O((L/n)^2) ~ sub-millimetre for the
reference's ~14 m track.
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np

from colaborativempc_tpu.geometry.tracks import Track
from colaborativempc_tpu.geometry.frenet import (
    frenet_to_cartesian, segment_index, wrap_s,
)


# ---------------------------------------------------------------------------
# Host-side fit pipeline (numpy/scipy, float64)
# ---------------------------------------------------------------------------

def remove_outliers(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop points closer than 0.7x the mean spacing to the last kept point.

    Same acceptance rule as the reference's outlierRemoval
    (``arc_length_spline.cpp:108-175``): walk the polyline, keep a point only
    if it is at least ``0.7 * mean_dist`` away from the previously *kept*
    point; always keep the first and last points.
    """
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if x.size != y.size:
        raise ValueError("x and y must have the same length")
    if x.size < 3:
        return x, y
    d = np.hypot(np.diff(x), np.diff(y))
    mean_dist = float(d.mean())
    keep = [0]
    j = 0
    for i in range(1, x.size - 1):
        if math.hypot(x[i] - x[j], y[i] - y[j]) >= 0.7 * mean_dist:
            keep.append(i)
            j = i
    keep.append(x.size - 1)
    return x[keep], y[keep]


def _chord_arclength(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Cumulative piecewise-linear arc length (``compArcLength``)."""
    return np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])


def _estimate_noise(x: np.ndarray, y: np.ndarray) -> float:
    """Robust waypoint-noise scale from third differences.

    Third differences annihilate quadratics, so the smooth-curve contribution
    is O(h^3) (negligible) while iid point noise of scale sigma contributes a
    2D residual with per-coordinate variance 20*sigma^2; the median of its
    magnitude (Rayleigh) is sqrt(20*ln(4))*sigma ~ 5.27*sigma.
    """
    if x.size < 6:
        return 0.0
    d3 = np.hypot(np.diff(x, 3), np.diff(y, 3))
    return float(np.median(d3) / math.sqrt(20.0 * math.log(4.0)))


class _ParamSpline:
    """Parametric (optionally smoothing, optionally periodic) 2D spline."""

    def __init__(self, s, x, y, closed: bool, smooth: float):
        from scipy.interpolate import splprep
        if closed and not (np.isclose(x[0], x[-1])
                           and np.isclose(y[0], y[-1])):
            s = np.concatenate([s, [s[-1] + math.hypot(x[0] - x[-1],
                                                       y[0] - y[-1])]])
            x = np.concatenate([x, [x[0]]])
            y = np.concatenate([y, [y[0]]])
        self.tck, _ = splprep([x, y], u=s, s=smooth, per=int(closed), k=3)
        self.total = float(s[-1])

    def __call__(self, s, der: int = 0):
        from scipy.interpolate import splev
        xs, ys = splev(np.asarray(s, np.float64), self.tck, der=der)
        return np.asarray(xs), np.asarray(ys)


def fit_centerline(x, y, halfwidth=0.5, closed: bool | None = None,
                   n_segments: int = 1000, slack: float = 0.15,
                   clean: bool = True, smooth: float | None = None,
                   dtype=jnp.float32) -> Track:
    """Fit a measured X/Y centerline into a device-ready ``Track`` table.

    Pipeline (reference ``gen2DSpline``, ``arc_length_spline.cpp:226-236``):
    outlier removal -> chord-length spline fit -> arc-length resample ->
    second fit/resample pass -> per-segment pose/curvature extraction.

    Args:
      x, y: centerline waypoints (any spacing; may be noisy/irregular).
      halfwidth: scalar half-width, or an array of per-waypoint half-widths
        sampled at the *output* segment grid (length ``n_segments``).
      closed: loop the track (auto-detected from endpoint proximity if None).
      n_segments: resolution of the emitted segment table.
      slack: out-of-track tolerance band carried by the Track.
      clean: apply outlier removal (disable for already-regular data).
    """
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if closed is None:
        d = np.hypot(np.diff(x), np.diff(y))
        closed = bool(math.hypot(x[-1] - x[0], y[-1] - y[0]) < 3.0 * d.mean())
    if clean:
        x, y = remove_outliers(x, y)
    if closed and np.isclose(x[0], x[-1]) and np.isclose(y[0], y[-1]):
        x, y = x[:-1], y[:-1]  # drop duplicate closure point

    # smoothing budget: total squared residual allowance for the fit. The
    # reference fits interpolating splines (its recorded tracks are already
    # smoothed); measured data needs the noise absorbed BEFORE second
    # derivatives (curvature) are read off, so default to an automatic
    # estimate of the waypoint noise.
    if smooth is None:
        sigma = _estimate_noise(x, y)
        smooth = x.size * (2.0 * sigma) ** 2

    # pass 1: chord-length parameter fit (smoothing), resample equidistantly
    s1 = _chord_arclength(np.concatenate([x, x[:1]]) if closed else x,
                          np.concatenate([y, y[:1]]) if closed else y)
    spl = _ParamSpline(s1[: x.size], x, y, closed, smooth)
    n_mid = max(n_segments, x.size)
    s_mid = np.linspace(0.0, spl.total, n_mid, endpoint=not closed)
    x2, y2 = spl(s_mid)

    # pass 2: refit on the refined arc-length approximation (now noise-free:
    # interpolate). Successive fit/resample converges the parameter to true
    # arc length — same scheme as the reference's fitSpline two-pass
    # (arc_length_spline.cpp:183-222).
    s2 = _chord_arclength(np.concatenate([x2, x2[:1]]) if closed else x2,
                          np.concatenate([y2, y2[:1]]) if closed else y2)
    spl = _ParamSpline(s2[: x2.size], x2, y2, closed, 0.0)
    sx = lambda s, der=0: spl(s, der)[0]  # noqa: E731
    sy = lambda s, der=0: spl(s, der)[1]  # noqa: E731
    total = spl.total

    # final segment grid: start poses from the spline, curvature at midpoints
    n = n_segments
    s0 = np.linspace(0.0, total, n, endpoint=False) if closed else \
        np.linspace(0.0, total, n + 1)[:-1]
    seg_len = np.full(n, total / n)
    xs, ys = sx(s0), sy(s0)
    dxs, dys = sx(s0, 1), sy(s0, 1)
    psis = np.arctan2(dys, dxs)
    sm = s0 + 0.5 * seg_len
    sm_eval = np.mod(sm, total) if closed else np.minimum(sm, total)
    dx1, dy1 = sx(sm_eval, 1), sy(sm_eval, 1)
    dx2, dy2 = sx(sm_eval, 2), sy(sm_eval, 2)
    denom = np.maximum((dx1 * dx1 + dy1 * dy1) ** 1.5, 1e-12)
    curv = (dx1 * dy2 - dy1 * dx2) / denom

    hw = np.broadcast_to(np.atleast_1d(np.asarray(halfwidth, np.float64)),
                         (n,)).copy()

    # dtype=float64 tables are a real x64 island (utils/precision.py) —
    # without the scoped flag JAX silently truncates the request to f32
    from colaborativempc_tpu.utils.precision import dtype_island
    with dtype_island(dtype):
        return Track(
            x0=jnp.asarray(xs[None, :], dtype),
            y0=jnp.asarray(ys[None, :], dtype),
            psi0=jnp.asarray(psis[None, :], dtype),
            s0=jnp.asarray(s0[None, :], dtype),
            length=jnp.asarray(seg_len[None, :], dtype),
            curv=jnp.asarray(curv[None, :], dtype),
            halfwidth=jnp.asarray(hw[None, :], dtype),
            track_length=jnp.asarray([total], dtype),
            open_flag=jnp.asarray(not closed),
            slack=jnp.asarray(slack, dtype),
        )


def halfwidth_from_boundaries(center_xy, inner_xy, outer_xy,
                              margin: float = 0.0) -> np.ndarray:
    """Per-centerline-point half-width from measured boundary polylines.

    The reference track JSON carries inner/outer boundary point sets alongside
    the centerline (``Params/track.cpp`` X_i/Y_i, X_o/Y_o); the corridor
    constraint then bounds the deviation from center. Half-width at each
    center point = min distance to either boundary, minus ``margin``.
    """
    c = np.asarray(center_xy, np.float64)
    i = np.asarray(inner_xy, np.float64)
    o = np.asarray(outer_xy, np.float64)
    di = np.sqrt(((c[:, None, :] - i[None, :, :]) ** 2).sum(-1)).min(1)
    do = np.sqrt(((c[:, None, :] - o[None, :, :]) ** 2).sum(-1)).min(1)
    return np.maximum(np.minimum(di, do) - margin, 1e-3)


def load_track_json(path: str):
    """Load a reference-format track JSON (``Params/track.cpp:28-42``).

    Returns dict with keys ``X, Y`` (centerline) and, when present,
    ``X_i, Y_i, X_o, Y_o`` (inner/outer boundaries) as float64 arrays.
    """
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for k in ("X", "Y", "X_i", "Y_i", "X_o", "Y_o"):
        if k in raw:
            out[k] = np.asarray(raw[k], np.float64)
    if "X" not in out or "Y" not in out:
        raise ValueError(f"{path}: track JSON must carry X and Y arrays")
    return out


def track_from_json(path: str, n_segments: int = 1000, margin: float = 0.0,
                    slack: float = 0.15, dtype=jnp.float32) -> Track:
    """Reference track JSON -> fitted ``Track`` with measured half-widths."""
    d = load_track_json(path)
    x, y = d["X"], d["Y"]
    hw = 0.5
    if all(k in d for k in ("X_i", "Y_i", "X_o", "Y_o")):
        # evaluate half-width on the output grid: fit once to place the
        # segment starts, measure boundary distance at each, then refit with
        # the per-segment widths baked in
        t0 = fit_centerline(x, y, halfwidth=1.0, n_segments=n_segments,
                            slack=slack, dtype=jnp.float64)
        centers = np.stack([np.asarray(t0.x0[0]), np.asarray(t0.y0[0])], -1)
        hw = halfwidth_from_boundaries(
            centers, np.stack([d["X_i"], d["Y_i"]], -1),
            np.stack([d["X_o"], d["Y_o"]], -1), margin=margin)
    return fit_centerline(x, y, halfwidth=hw, n_segments=n_segments,
                          slack=slack, dtype=dtype)


# ---------------------------------------------------------------------------
# On-device projection (jittable)
# ---------------------------------------------------------------------------

def project_on_spline(track: Track, x, y, s_guess, lane: int = 0,
                      max_dist: float = 2.0, iters: int = 20,
                      tol: float = 1e-5):
    """Project a Cartesian point onto the track: argmin_s |p(s) - (x,y)|.

    The reference's ``porjectOnSpline`` (``arc_length_spline.cpp:267-309``):
    start from ``s_guess``; if the guess is further than ``max_dist`` from the
    path, re-seed from the globally nearest stored path point; then Newton on
    the squared distance (p' = tangent, p'' = curvature * normal for an
    arc-length path), falling back to the guess when not converged.

    Fully jittable; vmap over (x, y, s_guess) for batches.
    """
    dtype = track.x0.dtype
    p = jnp.stack([jnp.asarray(x, dtype), jnp.asarray(y, dtype)])

    def pos(s):
        px, py, theta = frenet_to_cartesian(track, s, 0.0, lane)
        return jnp.stack([px, py]), theta

    p0, _ = pos(s_guess)
    far = jnp.linalg.norm(p - p0) >= max_dist
    d2 = (track.x0[lane] - p[0]) ** 2 + (track.y0[lane] - p[1]) ** 2
    # padded segments carry s0=+inf; exclude them from the global re-seed
    d2 = jnp.where(jnp.isfinite(track.s0[lane]), d2, jnp.inf)
    s_seed = jnp.where(far, track.s0[lane][jnp.argmin(d2)],
                       jnp.asarray(s_guess, dtype))

    def body(_, carry):
        s, done = carry
        pp, theta = pos(s)
        idx, _ = segment_index(track, s, lane)
        kappa = track.curv[lane][idx]
        t_hat = jnp.stack([jnp.cos(theta), jnp.sin(theta)])
        n_hat = jnp.stack([-jnp.sin(theta), jnp.cos(theta)])
        diff = pp - p
        hi = jax.lax.Precision.HIGHEST
        jac = 2.0 * jnp.dot(diff, t_hat, precision=hi)
        hess = 2.0 + 2.0 * kappa * jnp.dot(diff, n_hat, precision=hi)  # |p'| = 1
        step = jac / jnp.where(jnp.abs(hess) < 1e-6,
                               jnp.where(hess < 0, -1e-6, 1e-6), hess)
        s_new = wrap_s(track, s - step, lane)
        done_new = done | (jnp.abs(s_new - s) <= tol)
        return (jnp.where(done, s, s_new), done_new)

    s_fin, converged = jax.lax.fori_loop(
        0, iters, body, (s_seed, jnp.asarray(False)))
    return jnp.where(converged, s_fin, jnp.asarray(s_guess, dtype))
