"""Arbitrary-track ingestion tests: measured centerline -> Track table.

Reference capability: MPCC-master/C++/Spline (outlierRemoval, gen2DSpline,
porjectOnSpline) + the JSON track loader Params/track.cpp. Tests follow the
reference's own validation style (spline vs analytic curves,
Tests/spline_test.cpp) plus round-trip identities.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest

from colaborativempc_tpu.geometry import (
    fit_centerline, track_from_json, project_on_spline, remove_outliers,
    halfwidth_from_boundaries, frenet_to_cartesian, cartesian_to_frenet,
    curvature, halfwidth,
)



@pytest.fixture()
def x64():
    """Scoped x64 island: these tests exercise REAL float64 tables
    (utils/precision.py) — queries must trace under the island too."""
    from colaborativempc_tpu.utils.precision import x64_island
    with x64_island():
        yield


def _circle_points(R=2.0, n=200, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = R * np.cos(th) + noise * rng.standard_normal(n)
    y = R * np.sin(th) + noise * rng.standard_normal(n)
    return x, y


def test_remove_outliers_reference_rule():
    """Points closer than 0.7x mean spacing to the last kept point drop."""
    x = np.array([0.0, 1.0, 1.01, 2.0, 2.02, 3.0, 4.0])
    y = np.zeros_like(x)
    xc, yc = remove_outliers(x, y)
    d = np.hypot(np.diff(xc), np.diff(yc))
    mean0 = np.hypot(np.diff(x), np.diff(y)).mean()
    assert (d >= 0.7 * mean0 - 1e-12).all()
    assert xc[0] == x[0] and xc[-1] == x[-1]  # endpoints always kept


def test_fit_circle_geometry_clean(x64):
    """Closed exact circle: arc length and curvature recovered tightly."""
    R = 2.0
    x, y = _circle_points(R=R, n=300)
    track = fit_centerline(x, y, halfwidth=0.4, n_segments=600,
                           dtype=jnp.float64)
    assert not bool(track.open_flag)
    L = float(track.track_length[0])
    assert abs(L - 2 * np.pi * R) < 2e-3 * R
    ks = np.asarray(curvature(track, jnp.linspace(0.1, L - 0.1, 50)))
    assert np.allclose(ks, 1.0 / R, rtol=5e-3)


def test_fit_circle_geometry_noisy(x64):
    """Noisy measured circle: smoothing fit keeps curvature usable."""
    R = 2.0
    x, y = _circle_points(R=R, n=300, noise=1e-3)
    track = fit_centerline(x, y, halfwidth=0.4, n_segments=600,
                           dtype=jnp.float64)
    L = float(track.track_length[0])
    assert abs(L - 2 * np.pi * R) < 2e-2 * R
    # curvature ~ 1/R everywhere (ccw circle -> positive kappa); the noise
    # floor for 1e-3 point noise leaves ~ +/-7% curvature ripple
    ks = np.asarray(curvature(track, jnp.linspace(0.1, L - 0.1, 50)))
    assert np.allclose(ks, 1.0 / R, rtol=0.1)
    # centerline points lie on the circle
    s = jnp.linspace(0.0, L, 200)
    px, py, _ = frenet_to_cartesian(track, s, jnp.zeros_like(s))
    rad = np.hypot(np.asarray(px), np.asarray(py))
    assert np.abs(rad - R).max() < 5e-3


def test_fit_roundtrip_frenet_cartesian(x64):
    """(s, ey) -> (x, y, psi) -> (s, ey, epsi) closes to tolerance on a
    fitted track (the VERDICT acceptance identity)."""
    x, y = _circle_points(R=2.0, n=250, noise=5e-4, seed=3)
    track = fit_centerline(x, y, halfwidth=0.4, n_segments=500,
                           dtype=jnp.float64)
    L = float(track.track_length[0])
    rng = np.random.default_rng(1)
    s_in = jnp.asarray(rng.uniform(0.05, L - 0.05, 40))
    ey_in = jnp.asarray(rng.uniform(-0.3, 0.3, 40))
    px, py, th = frenet_to_cartesian(track, s_in, ey_in)
    back = jax.vmap(lambda a, b, c: cartesian_to_frenet(track, a, b, c))(
        px, py, th)
    s_out, ey_out, epsi_out, valid = back
    assert bool(jnp.all(valid))
    assert np.abs(np.asarray(ey_out) - np.asarray(ey_in)).max() < 2e-3
    assert np.abs(np.asarray(epsi_out)).max() < 2e-3
    ds = np.abs(np.asarray(s_out) - np.asarray(s_in))
    ds = np.minimum(ds, L - ds)  # wrap-safe
    assert ds.max() < 2e-3


def test_fit_open_curve(x64):
    """Open (non-looping) measured centerline: an S-curve."""
    t = np.linspace(0.0, 6.0, 120)
    x, y = t, 0.8 * np.sin(t)
    track = fit_centerline(x, y, halfwidth=0.5, n_segments=400,
                           dtype=jnp.float64)
    assert bool(track.open_flag)
    L = float(track.track_length[0])
    # arc length of y=0.8 sin(t): integral of sqrt(1+0.64 cos^2)
    tt = np.linspace(0, 6, 20001)
    L_true = np.trapezoid(np.sqrt(1 + 0.64 * np.cos(tt) ** 2), tt)
    assert abs(L - L_true) < 1e-2
    s = jnp.linspace(0.1, L - 0.1, 100)
    px, py, _ = frenet_to_cartesian(track, s, jnp.zeros_like(s))
    # every centerline point sits on the analytic curve
    assert np.abs(np.asarray(py) - 0.8 * np.sin(np.asarray(px))).max() < 5e-3


def test_project_on_spline_newton_and_reseed(x64):
    R = 2.0
    x, y = _circle_points(R=R, n=300)
    track = fit_centerline(x, y, halfwidth=0.4, n_segments=600,
                           dtype=jnp.float64)
    L = float(track.track_length[0])
    proj = jax.jit(lambda px, py, sg: project_on_spline(track, px, py, sg))
    # point off-center at angle pi/3 -> s = R*pi/3, from a nearby guess
    th = np.pi / 3
    s_true = R * th
    s1 = float(proj(1.1 * R * np.cos(th), 1.1 * R * np.sin(th), s_true + 0.3))
    assert abs(s1 - s_true) < 1e-3
    # far-off guess (> max_dist from its path point) triggers global re-seed
    # (reference porjectOnSpline dist-too-large branch)
    s2 = float(proj(1.1 * R * np.cos(th), 1.1 * R * np.sin(th),
                    (s_true + 0.45 * L) % L))
    assert abs(s2 - s_true) < 1e-3


def test_boundary_halfwidths():
    x, y = _circle_points(R=2.0, n=100)
    xi, yi = _circle_points(R=1.7, n=90)
    xo, yo = _circle_points(R=2.4, n=110)
    hw = halfwidth_from_boundaries(
        np.stack([x, y], -1), np.stack([xi, yi], -1), np.stack([xo, yo], -1))
    # limited by the nearer (inner) boundary: ~0.3
    assert np.allclose(hw, 0.3, atol=0.02)


def test_reference_track_json_ingests(x64, track_json):
    """A reference-format MPCC track JSON (489 centerline points with
    inner/outer boundaries, sampled from the in-repo oval_mt) fits,
    closes, and round-trips."""
    track = track_from_json(track_json, n_segments=800, dtype=jnp.float64)
    assert not bool(track.open_flag)          # it is a closed race track
    L = float(track.track_length[0])
    assert L > 5.0                            # sane total length
    hws = np.asarray(track.halfwidth[0])
    assert (hws > 0.05).all() and (hws < 1.0).all()
    # round-trip a lap of centerline points
    s = jnp.linspace(0.05, L - 0.05, 60)
    px, py, th = frenet_to_cartesian(track, s, jnp.zeros_like(s))
    back = jax.vmap(lambda a, b, c: cartesian_to_frenet(track, a, b, c))(
        px, py, th)
    assert bool(jnp.all(back[3]))
    assert np.abs(np.asarray(back[1])).max() < 5e-3  # ey ~ 0 on centerline


def test_mpcc_races_fitted_track():
    """The racing planner completes meaningful progress on an ingested
    (measured-centerline) track — the VERDICT acceptance run."""
    from colaborativempc_tpu.dynamics import PacejkaParams
    from colaborativempc_tpu.planners import MPCCGains, mpcc_solve

    x, y = _circle_points(R=2.5, n=200, noise=1e-3)
    track = fit_centerline(x, y, halfwidth=0.45, n_segments=400)
    P = PacejkaParams()
    gains = MPCCGains()
    N, dt = 20, 0.05
    xs = jnp.zeros(9, jnp.float32).at[0].set(0.5)
    x_bar = jnp.stack([xs] * (N + 1))
    x_bar = x_bar.at[:, 6].set(jnp.arange(N + 1, dtype=jnp.float32) * 0.5 * dt)
    u_bar = jnp.zeros((N, 2), jnp.float32).at[:, 1].set(0.2)
    u_old = jnp.zeros(2, jnp.float32)
    solve = jax.jit(lambda x0, xb, ub, uo: mpcc_solve(
        track, gains, P, N, dt, x0, xb, ub, uo))
    ss, eys = [], []
    for _ in range(25):
        sol = solve(xs, x_bar, u_bar, u_old)
        xs = sol.x_pred[1]
        u_old = sol.u_pred[0]
        x_bar = jnp.concatenate([sol.x_pred[1:], sol.x_pred[-1:]])
        u_bar = jnp.concatenate([sol.u_pred[1:], sol.u_pred[-1:]])
        ss.append(float(xs[6])); eys.append(float(xs[3]))
    assert ss[-1] > 0.6, ss
    assert (np.diff(ss) > -1e-3).all()
    assert max(abs(e) for e in eys) < 0.45
