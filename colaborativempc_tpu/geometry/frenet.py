"""Vectorised Frenet <-> Cartesian transforms and track lookups.

On-device replacements for the reference's per-call Python segment loops
(``mapManager/track_initialization.py:325-535``, ``utilities/misc.py:78-126``):
every query is a gather over the precompiled segment table, fully jittable and
vmappable over horizon stages, agents and scenario batches.

All functions accept scalar or arbitrarily-batched ``s`` / ``(x, y)`` inputs
(they are written element-wise over jnp arrays).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from colaborativempc_tpu.geometry.tracks import Track

_EPS_KAPPA = 1e-8


def wrap_s(track: Track, s, lane: int = 0):
    """Wrap arc-length onto [0, track_length) (closed) or clamp (open).

    Reference semantics: ``track_initialization.py:305-317`` (open tracks
    subtract one lap then clamp at 0; closed tracks wrap modulo length).
    """
    L = track.track_length[lane]
    s = jnp.maximum(jnp.asarray(s), 0.0)  # negatives clamp to 0 first
    s_closed = jnp.mod(s, L)
    s_open = jnp.where(s >= L, s - L, s)
    return jnp.where(track.open_flag, s_open, s_closed)


def check_lap(track: Track, s, lane: int = 0):
    """Completed-lap count (reference ``track_initialization.py:319-323``)."""
    return jnp.floor(jnp.asarray(s) / track.track_length[lane])


def segment_index(track: Track, s, lane: int = 0):
    """Index of the segment containing wrapped arc-length ``s``."""
    sw = wrap_s(track, s, lane)
    # side='right' skips zero-length segments whose s0 duplicates
    idx = jnp.searchsorted(track.s0[lane], sw, side="right") - 1
    return jnp.clip(idx, 0, track.n_segments - 1), sw


def curvature(track: Track, s, lane: int = 0):
    """Signed curvature at ``s`` (reference ``utilities/misc.py:78-102``)."""
    idx, _ = segment_index(track, s, lane)
    return track.curv[lane][idx]


def halfwidth(track: Track, s, lane: int = 0, sm: float = 1.0):
    """Lane half-width at ``s``, optionally shrunk by safety margin ``sm``
    (reference ``utilities/misc.py:105-126``)."""
    idx, _ = segment_index(track, s, lane)
    return track.halfwidth[lane][idx] * sm


def frenet_to_cartesian(track: Track, s, ey, lane: int = 0):
    """Map curvilinear ``(s, ey)`` to inertial ``(x, y, theta)``.

    Single smooth formula covering straights and arcs (the arc expression
    converges to the straight one as curvature -> 0), selected with
    ``jnp.where`` so it stays jittable — unlike the per-segment branch of the
    reference (``track_initialization.py:325-399``) it vectorises over any
    batch of query points.
    """
    idx, sw = segment_index(track, s, lane)
    x0 = track.x0[lane][idx]
    y0 = track.y0[lane][idx]
    psi = track.psi0[lane][idx]
    kappa = track.curv[lane][idx]
    ds = sw - track.s0[lane][idx]

    theta = psi + kappa * ds
    straight = jnp.abs(kappa) < _EPS_KAPPA
    rho = 1.0 / jnp.where(straight, 1.0, kappa)  # signed radius, safe div

    x_arc = x0 + rho * (jnp.sin(theta) - jnp.sin(psi)) - ey * jnp.sin(theta)
    y_arc = y0 + rho * (jnp.cos(psi) - jnp.cos(theta)) + ey * jnp.cos(theta)
    x_str = x0 + ds * jnp.cos(psi) - ey * jnp.sin(psi)
    y_str = y0 + ds * jnp.sin(psi) + ey * jnp.cos(psi)

    x = jnp.where(straight, x_str, x_arc)
    y = jnp.where(straight, y_str, y_arc)
    return x, y, theta


def wrap_to_pi(a):
    """Wrap angle(s) to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def cartesian_to_frenet(track: Track, x, y, psi, lane: int = 0):
    """Map inertial ``(x, y, psi)`` to curvilinear ``(s, ey, epsi, valid)``.

    Vectorised over segments: candidate local coordinates are computed for all
    segments at once with validity masks, and the first valid segment wins —
    same selection rule as the reference's sequential scan with early break
    (``track_initialization.py:438-535``). Out-of-track points return the
    reference's sentinel (1e4, 1e4, 1e4, False).

    Scalar (x, y, psi) per call; use jax.vmap for batches.
    """
    lx0 = track.x0[lane]
    ly0 = track.y0[lane]
    lpsi = track.psi0[lane]
    ls0 = track.s0[lane]
    llen = track.length[lane]
    lk = track.curv[lane]
    lhw = track.halfwidth[lane]

    p = jnp.stack([jnp.asarray(x, lx0.dtype), jnp.asarray(y, lx0.dtype)])

    straight = jnp.abs(lk) < _EPS_KAPPA
    nondegenerate = llen > 0.0

    # Per-segment boundary tolerance: on dense spline-fitted tables
    # (geometry/spline.py) a query can land exactly on a segment boundary
    # and float rounding would make BOTH adjacent segments reject it; the
    # reference's coarse segments never hit this (its boundaries are exact
    # in float64, track_initialization.py:438-535).
    tol_s = 1e-3 * llen

    # ---- straight-segment candidates -------------------------------------
    t_hat = jnp.stack([jnp.cos(lpsi), jnp.sin(lpsi)], axis=-1)
    n_hat = jnp.stack([-jnp.sin(lpsi), jnp.cos(lpsi)], axis=-1)
    v = p[None, :] - jnp.stack([lx0, ly0], axis=-1)
    s_loc_str = jnp.sum(v * t_hat, axis=-1)
    ey_str = jnp.sum(v * n_hat, axis=-1)
    valid_str = ((s_loc_str >= -tol_s) & (s_loc_str <= llen + tol_s)
                 & (jnp.abs(ey_str) <= lhw + track.slack))
    epsi_str = wrap_to_pi(psi - lpsi)

    # ---- arc-segment candidates ------------------------------------------
    kappa_safe = jnp.where(straight, 1.0, lk)
    rho = 1.0 / kappa_safe                      # signed radius
    cx = lx0 - rho * jnp.sin(lpsi)
    cy = ly0 + rho * jnp.cos(lpsi)
    w = p[None, :] - jnp.stack([cx, cy], axis=-1)
    v0 = jnp.stack([lx0 - cx, ly0 - cy], axis=-1)  # center -> segment start
    # signed angle from v0 to w (reference computeAngle,
    # track_initialization.py:545-562)
    dot = jnp.sum(v0 * w, axis=-1)
    det = v0[:, 0] * w[:, 1] - v0[:, 1] * w[:, 0]
    arc2 = jnp.arctan2(det, dot)
    arc1 = llen * lk                            # total signed span
    r_abs = jnp.abs(rho)
    s_loc_arc = jnp.abs(arc2) * r_abs
    ey_arc = -jnp.sign(lk) * (jnp.linalg.norm(w, axis=-1) - r_abs)
    valid_arc = (((jnp.sign(arc1) == jnp.sign(arc2)) | (s_loc_arc <= tol_s))
                 & (s_loc_arc <= llen + tol_s)
                 & (jnp.abs(ey_arc) <= 3.0 * lhw + track.slack))
    epsi_arc = wrap_to_pi(psi - (lpsi + arc2))

    s_loc = jnp.where(straight, s_loc_str, s_loc_arc)
    ey = jnp.where(straight, ey_str, ey_arc)
    epsi = jnp.where(straight, epsi_str, epsi_arc)
    valid = jnp.where(straight, valid_str, valid_arc) & nondegenerate

    any_valid = jnp.any(valid)
    # Among valid candidates, take the one with the smallest |ey|. The
    # reference's sequential scan takes the FIRST valid segment
    # (track_initialization.py:438-535, early break) — equivalent when the
    # valid segment is unique, as it is for the coarse analytic tracks; on
    # dense spline-fitted tables (geometry/spline.py) opposite track sides
    # can both fall inside the acceptance band, and nearest-|ey| is the
    # correct localisation.
    first = jnp.argmin(jnp.where(valid, jnp.abs(ey), jnp.inf))

    sentinel = jnp.asarray(1e4, lx0.dtype)
    s_out = jnp.where(any_valid, ls0[first] + s_loc[first], sentinel)
    ey_out = jnp.where(any_valid, ey[first], sentinel)
    epsi_out = jnp.where(any_valid, epsi[first], sentinel)
    return s_out, ey_out, epsi_out, any_valid


def check_lane(track: Track, x, y, psi):
    """Localise against every lane and return the best (min |ey|) one.

    Reference ``track_initialization.py:418-436``.
    Returns (s, ey, epsi, valid, lane).
    """
    results = [cartesian_to_frenet(track, x, y, psi, lane=k)
               for k in range(track.n_lanes)]
    s = jnp.stack([r[0] for r in results])
    ey = jnp.stack([r[1] for r in results])
    epsi = jnp.stack([r[2] for r in results])
    valid = jnp.stack([r[3] for r in results])
    best = jnp.argmin(jnp.abs(ey))
    return s[best], ey[best], epsi[best], valid[best], best


def relocalize(track: Track, x: jnp.ndarray, lane,
               old_lane=None) -> jnp.ndarray:
    """Recompute one 9-state vehicle's Frenet entries (ey, epsi, s) from its
    pose (X, Y, theta) against the given lane, preserving lap continuity:
    the new s keeps the lap multiple consistent with the old s (reference
    ``set_lane`` re-runs getLocalPosition on the new lane,
    ``track_initialization.py:302``). An out-of-lane pose keeps the old
    Frenet entries (the localisation sentinel must not poison the state).

    ``old_lane``: the lane the incoming ``x[6]`` was measured on. When the
    lanes differ in length, the completed-lap count is derived against the
    OLD lane's length (with the new lane's fractional progress rescaled
    proportionally), so after many laps the rounding argument stays ~integer
    instead of drifting by laps*|L_old-L_new| — which would eventually land
    on the wrong lap and corrupt check_end counting. Defaults to ``lane``
    (same-lane re-localisation, e.g. the MPCC driver's per-step projection).
    """
    s_loc, ey, epsi, valid = cartesian_to_frenet(track, x[7], x[8], x[5],
                                                 lane=lane)
    L = track.track_length[lane]
    L_old = L if old_lane is None else track.track_length[old_lane]
    k = jnp.round((x[6] - s_loc * L_old / L) / L_old)
    s_new = k * L + s_loc
    x = x.at[3].set(jnp.where(valid, ey, x[3]))
    x = x.at[4].set(jnp.where(valid, epsi, x[4]))
    x = x.at[6].set(jnp.where(valid, s_new, x[6]))
    return x


def select_lane(track: Track, x: jnp.ndarray, prev_lane=None):
    """Dynamic lane selection for one 9-state vehicle: localise the pose
    against every lane, pick the best (min |ey|) one, and relocalise the
    Frenet entries onto it — the per-step ``checkLane``/``set_lane`` switch
    of the reference (``track_initialization.py:302,418-436``).
    Returns ``(lane, x')``; jit/vmap-safe (lane is a traced int index into
    the lane-major track tables). Pass ``prev_lane`` (the lane ``x[6]`` was
    measured on) for exact lap bookkeeping when lanes differ in length —
    see :func:`relocalize`."""
    _, ey, _, _, lane = check_lane(track, x[7], x[8], x[5])
    return lane, relocalize(track, x, lane, old_lane=prev_lane)


def check_end(track: Track, s, laps: int = 1, lane: int = 0, atol: float = 0.15):
    """True when an agent has completed ``laps`` laps.

    Reference ``utilities/misc.py:28-48``: finish when s is within ``atol`` of
    (or beyond) the track length and the completed-lap count matches.
    """
    L = track.track_length[lane]
    s = jnp.asarray(s)
    cl = jnp.floor(s / L)
    return (jnp.isclose(s, L, atol=atol) | (s > L)) & (cl == laps)
