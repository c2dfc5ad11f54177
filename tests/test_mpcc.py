"""MPCC racing planner + closed-loop driver tests.

Native reference analogue: MPCC-master/C++ closed-loop sim (main.cpp), the
MPC driver's warm-start/failure management (MPC/mpc.cpp:135-252), the
JSON config surface (Params/, main.cpp:33-41) and its model/constraint unit
tests (Tests/).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from colaborativempc_tpu.dynamics import (
    PacejkaParams, f_continuous_pacejka, tire_forces,
    friction_ellipse_residual, slip_angle_residuals, linearize_pacejka,
)
from colaborativempc_tpu.geometry import (
    make_track, curvature, frenet_to_cartesian, wrap_to_pi,
)
from colaborativempc_tpu.planners import (
    MPCCGains, MPCCBounds, MPCCNormalization, MPCCConfig, mpcc_solve,
    mpcc_config_from_json, mpcc_config_to_json,
)
from colaborativempc_tpu.runtime.racing import (
    MPCCState, init_mpcc, make_mpcc_step, make_mpcc_rollout,
    run_mpcc_experiment, load_mpcc_track,
    _warm_guess, _cold_guess, _relocalize_unwrapped,
)

P = PacejkaParams()


def _warm_inputs(N=20, dt=0.05):
    x = jnp.zeros(9, jnp.float32).at[0].set(0.5)
    x_bar = jnp.stack([x + jnp.zeros(9)] * (N + 1))
    s_ramp = jnp.arange(N + 1, dtype=jnp.float32) * 0.5 * dt
    x_bar = x_bar.at[:, 6].set(s_ramp)
    u_bar = jnp.zeros((N, 2), jnp.float32).at[:, 1].set(0.2)
    return x, x_bar, u_bar, jnp.zeros(2, jnp.float32)


def test_pacejka_forces_sane():
    x = jnp.asarray([1.0, 0.05, 0.1, 0, 0, 0, 0, 0, 0], jnp.float32)
    u = jnp.asarray([0.1, 0.5], jnp.float32)
    F_fy, F_ry, F_rx = tire_forces(x, u, P)
    # lateral forces bounded by the magic-formula peaks
    assert abs(float(F_fy)) <= P.Df + 1e-6
    assert abs(float(F_ry)) <= P.Dr + 1e-6
    # drivetrain pushes forward at positive duty
    assert float(F_rx) > 0


def test_pacejka_jacobian_matches_fd():
    """Autodiff linearisation vs finite differences (the reference
    hand-derives these, Tests/model_integrator_test.cpp)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=9) * 0.1 +
                    np.array([1.0, 0, 0, 0, 0, 0, 0, 0, 0]), jnp.float32)
    u = jnp.asarray([0.05, 0.4], jnp.float32)
    dt, kap = 0.02, 0.3
    Ad, Bd, rd = linearize_pacejka(x, u, kap, P, dt)
    eps = 1e-4
    for i in range(9):
        dx = np.zeros(9, np.float32); dx[i] = eps
        fp = x + dx + dt * f_continuous_pacejka(x + dx, u, kap, P)
        fm = x - dx + dt * f_continuous_pacejka(x - dx, u, kap, P)
        fd = np.asarray(fp - fm) / (2 * eps)
        assert np.allclose(np.asarray(Ad)[:, i], fd, atol=5e-2), i


def test_mpcc_closed_loop_races():
    """Closed loop on the raw per-solve API: the racing planner
    accelerates, makes progress, stays inside the track band and respects
    the tire limits."""
    track = make_track("oval_mt")
    gains = MPCCGains()
    N, dt = 20, 0.05
    x, x_bar, u_bar, u_old = _warm_inputs(N, dt)

    solve = jax.jit(lambda x0, xb, ub, uo: mpcc_solve(
        track, gains, P, N, dt, x0, xb, ub, uo))

    ss, eys, fes = [], [], []
    for _ in range(30):
        sol = solve(x, x_bar, u_bar, u_old)
        x = sol.x_pred[1]
        u_old = sol.u_pred[0]
        x_bar = jnp.concatenate([sol.x_pred[1:], sol.x_pred[-1:]])
        u_bar = jnp.concatenate([sol.u_pred[1:], sol.u_pred[-1:]])
        ss.append(float(x[6])); eys.append(float(x[3]))
        fes.append(float(friction_ellipse_residual(x, u_old, P)))
    assert ss[-1] > 0.8, ss[-1]            # raced forward
    assert (np.diff(ss) > -1e-3).all()     # monotone progress
    assert max(abs(e) for e in eys) < 0.5  # inside the track
    assert max(fes) < 0.005                # friction ellipse respected


def test_normalized_solve_matches_raw():
    """The normalisation (params.h:31-58 T_x/T_u) is a pure change of
    variables: at the 1:43 scale (I=2.78e-5 against O(10) positions) the
    normalised and raw solves must agree to solver tolerance, both
    feasible — the float32-conditioning safeguard the reference considered
    mandatory, verified rather than assumed."""
    track = make_track("oval_mt")
    N, dt = 20, 0.05
    x, x_bar, u_bar, u_old = _warm_inputs(N, dt)
    norm = MPCCNormalization.default(dt)
    raw = mpcc_solve(track, MPCCGains(), P, N, dt, x, x_bar, u_bar, u_old,
                     norm=None)
    scl = mpcc_solve(track, MPCCGains(), P, N, dt, x, x_bar, u_bar, u_old,
                     norm=norm)
    assert bool(raw.feasible) and bool(scl.feasible)
    assert float(scl.r_prim) < 5e-3
    np.testing.assert_allclose(np.asarray(scl.x_pred),
                               np.asarray(raw.x_pred), atol=2e-2)
    np.testing.assert_allclose(np.asarray(scl.u_pred),
                               np.asarray(raw.u_pred), atol=2e-2)


def test_reference_config_loading(mpcc_params_dir):
    """A reference-layout Params/config.json master file loads end to end
    (main.cpp:33-41): model params, bounds, Ts/n_sqp/sqp_mixing, the
    normalisation JSON, and the track path."""
    REF_MPCC = mpcc_params_dir
    cfg = mpcc_config_from_json(os.path.join(REF_MPCC, "config.json"))
    assert cfg.dt == pytest.approx(0.02)
    assert cfg.n_sqp == 2 and cfg.n_reset == 5
    assert cfg.sqp_mixing == pytest.approx(0.8)
    # model.json values (Iz -> I, E_long -> p_long renames)
    assert cfg.model.m == pytest.approx(0.041)
    assert cfg.model.I == pytest.approx(27.8e-6)
    assert cfg.model.p_long == pytest.approx(0.9)
    assert cfg.model.max_alpha == pytest.approx(0.6)
    # bounds.json
    assert cfg.bounds.delta_max == pytest.approx(0.35)
    assert cfg.bounds.drive_min == pytest.approx(-0.1)
    assert cfg.track_json is not None and os.path.exists(cfg.track_json)
    norm = MPCCNormalization.from_reference(
        os.path.join(REF_MPCC, "normalization.json"), cfg.dt)
    assert float(norm.t_x[0]) == pytest.approx(3.0)    # vx
    assert float(norm.t_x[6]) == pytest.approx(20.0)   # s
    # the master file's normalization_path is carried on the config and
    # cfg.normalization() returns the LOADED reference scales, not defaults
    assert cfg.normalization_path is not None
    assert os.path.exists(cfg.normalization_path)
    assert np.allclose(np.asarray(cfg.normalization().t_x),
                       np.asarray(norm.t_x))
    assert float(norm.t_du[0]) == pytest.approx(15.0 * cfg.dt)


def test_config_json_roundtrip(tmp_path):
    cfg = MPCCConfig(N=12, dt=0.04, n_sqp=2, map_type="oval",
                     gains=MPCCGains(q_contour=33.0),
                     bounds=MPCCBounds(delta_max=0.3),
                     model=PacejkaParams(m=0.05))
    p = str(tmp_path / "mpcc.json")
    mpcc_config_to_json(cfg, p)
    back = mpcc_config_from_json(p)
    assert back == cfg


def test_race_fitted_reference_track(mpcc_params_dir):
    """Library-call closed loop on a reference-format track JSON, driven
    entirely from a reference-layout master config.json: progresses, no
    solver failures, stays within the measured corridor (+slack)."""
    cfg = mpcc_config_from_json(
        os.path.join(mpcc_params_dir, "config.json"),
        N=16, n_sim=60, verb=0)
    track = load_mpcc_track(cfg)
    res = run_mpcc_experiment(cfg, track=track)
    assert res.steps == 60
    assert np.all(np.isfinite(res.states))
    assert res.states[-1, 6] > 0.5             # made progress
    assert np.all(np.diff(res.states[:, 6]) > -1e-3)
    assert res.feasible.mean() > 0.9
    assert int(res.resets.sum()) == 1           # only the initial cold start
    # corridor: |ey| within the measured half-widths + slack band
    hw_max = float(jnp.max(track.halfwidth[0]))
    assert np.max(np.abs(res.states[:, 3])) < hw_max + float(track.slack)


def test_warm_guess_shift():
    """updateInitialGuess (mpc.cpp:135-150): stage 0 pinned to the measured
    state, interior stages shifted by one, RK4-style tail appended."""
    track = make_track("oval_mt")
    cfg = MPCCConfig(N=8, dt=0.05)
    rng = np.random.default_rng(1)
    x_bar = jnp.asarray(rng.normal(size=(9, 9)) * 0.1, jnp.float32)
    x_bar = x_bar.at[:, 0].add(1.0)
    x_bar = x_bar.at[:, 6].set(jnp.arange(9, dtype=jnp.float32) * 0.05)
    u_bar = jnp.asarray(rng.normal(size=(8, 2)) * 0.05, jnp.float32)
    x0 = x_bar[1] + 0.01
    x_new, u_new = _warm_guess(track, cfg, x0, x_bar, u_bar)
    np.testing.assert_allclose(np.asarray(x_new[0]), np.asarray(x0))
    np.testing.assert_allclose(np.asarray(x_new[1:-1]),
                               np.asarray(x_bar[2:]))
    np.testing.assert_allclose(np.asarray(u_new[:-1]), np.asarray(u_bar[1:]))
    assert np.all(np.asarray(u_new[-1]) == 0.0)
    tail = np.asarray(x_new[-1])
    assert np.all(np.isfinite(tail))
    assert tail[6] > float(x_bar[-1, 6])        # the tail advances s


def test_cold_guess_on_track():
    """generateNewInitialGuess (mpc.cpp:175-196): the fresh guess rolls
    along the centerline at initial_velocity with continuous heading."""
    track = make_track("oval_mt")
    cfg = MPCCConfig(N=24, dt=0.05, initial_velocity=1.5)
    x0 = jnp.zeros(9, jnp.float32).at[0].set(0.3).at[6].set(2.0)
    px, py, th = frenet_to_cartesian(track, 2.0, 0.0)
    x0 = x0.at[5].set(th).at[7].set(px).at[8].set(py)
    x_new, u_new = _cold_guess(track, cfg, x0)
    np.testing.assert_allclose(np.asarray(x_new[0]), np.asarray(x0))
    assert np.all(np.asarray(x_new[1:, 0]) == 1.5)
    np.testing.assert_allclose(
        np.diff(np.asarray(x_new[:, 6])), 1.5 * 0.05, atol=1e-5)
    # guess positions lie on the centerline
    for k in (6, 12, 23):
        gx, gy, _ = frenet_to_cartesian(track, x_new[k, 6], 0.0)
        assert abs(float(gx) - float(x_new[k, 7])) < 1e-4
        assert abs(float(gy) - float(x_new[k, 8])) < 1e-4
    # heading unwrapped: no 2pi jumps between stages
    dth = np.diff(np.asarray(x_new[:, 5]))
    assert np.max(np.abs(dth)) < 0.5
    assert np.all(np.asarray(u_new) == 0.0)


def test_relocalize_unwrapped_lap_seam():
    """The projection keeps s cumulative across the start/finish seam
    (mpc.cpp:223-224 porjectOnSpline + unwrap)."""
    track = make_track("oval_mt")
    L = float(track.track_length[0])
    # pose just past the seam, with s_prev just before it (one lap done)
    s_prev = 2 * L - 0.05
    px, py, th = frenet_to_cartesian(track, 0.03, 0.1)
    x = jnp.zeros(9, jnp.float32)
    x = x.at[5].set(th).at[6].set(s_prev).at[7].set(px).at[8].set(py)
    x_loc = _relocalize_unwrapped(track, x)
    assert abs(float(x_loc[6]) - (2 * L + 0.03)) < 5e-3   # NOT wrapped to 0.03
    assert abs(float(x_loc[3]) - 0.1) < 5e-3              # ey recovered
    assert abs(float(x_loc[4])) < 5e-3                    # epsi ~ 0


def test_failure_reset_recovers():
    """Solver-failure bookkeeping (mpc.cpp:231-252): a poisoned guess makes
    the SQP reject every QP; the driver keeps the plant finite, invalidates
    the guess, cold-starts the next step and the race recovers."""
    track = make_track("oval_mt")
    cfg = MPCCConfig(N=12, dt=0.05, n_sqp=2, n_reset=1)
    step = make_mpcc_step(track, cfg)
    state = init_mpcc(track, cfg)
    for _ in range(3):
        state, m = step(state)
    assert bool(state.valid_guess)
    s_before = float(state.x[6])

    # poison the warm start (the stand-in for a hard solver failure)
    state = state._replace(x_bar=state.x_bar * jnp.nan)
    state, m = step(state)
    assert int(m.sqp_fails) == cfg.n_sqp        # every QP rejected
    assert not bool(state.valid_guess)          # guess invalidated
    assert np.all(np.isfinite(np.asarray(state.x)))  # plant survived

    # next step cold-starts from the track and the solve recovers
    state, m = step(state)
    assert bool(m.reset)
    assert np.all(np.isfinite(np.asarray(state.x_bar)))
    assert bool(state.valid_guess)
    for _ in range(4):
        state, m = step(state)
    assert int(state.n_non_solves) == 0
    assert float(state.x[6]) > s_before         # racing again


def test_rollout_scan_matches_step_loop():
    """make_mpcc_rollout (one scanned device program) equals the per-step
    host loop exactly."""
    track = make_track("oval_mt")
    cfg = MPCCConfig(N=10, dt=0.05)
    steps = 5
    s1 = init_mpcc(track, cfg)
    step = make_mpcc_step(track, cfg)
    for _ in range(steps):
        s1, _ = step(s1)
    s2, metrics = make_mpcc_rollout(track, cfg, steps)(init_mpcc(track, cfg))
    np.testing.assert_allclose(np.asarray(s1.x), np.asarray(s2.x),
                               rtol=1e-5, atol=1e-6)
    assert metrics.s.shape == (steps,)


def test_run_mpcc_experiment_lap_termination():
    """cfg.laps terminates on lap completion with a lap time (the
    reference's n_sim loop has no termination; this matches the other
    planner families' checkEnd semantics)."""
    track = make_track("oval_mt")
    cfg = MPCCConfig(N=16, dt=0.05, n_sim=400, laps=1, verb=0)
    res = run_mpcc_experiment(cfg, track=track)
    L = float(track.track_length[0])
    assert res.finished
    assert res.states[-1, 6] >= L
    assert res.lap_time is not None and res.lap_time > 0
    assert res.steps < 400


def test_mpcc_battery_gain_sweep():
    """run_mpcc_battery races a whole tuning grid as ONE vmapped device
    program; more progress reward -> more progress, tighter contouring ->
    smaller |ey| (the trade-off the reference tunes by re-running its
    binary per hand-edited cost.json)."""
    from colaborativempc_tpu.runtime.battery import (
        run_mpcc_battery, mpcc_gain_grid,
    )
    cfg = MPCCConfig(N=10, dt=0.05, map_type="oval_mt")
    grid = mpcc_gain_grid(MPCCGains(), q_progress=[0.3, 3.0])
    res = run_mpcc_battery(cfg, grid, steps=30)
    assert res.n_configs == 2
    assert (res.feasible_frac > 0.9).all()
    assert np.all(np.isfinite(res.s_hist))
    # the aggressive progress gain races measurably farther
    assert res.progress[1] > res.progress[0] + 0.1, res.progress


def test_mpcc_battery_sharded_matches_single_device():
    """The racing battery sharded over the 8-device mesh (pure data
    parallel) equals the single-device run."""
    from jax.sharding import Mesh
    from colaborativempc_tpu.runtime.battery import (
        run_mpcc_battery, mpcc_gain_grid,
    )
    cfg = MPCCConfig(N=8, dt=0.05, map_type="oval_mt")
    grid = mpcc_gain_grid(MPCCGains(),
                          q_contour=[20.0, 50.0, 80.0, 120.0],
                          q_progress=[0.5, 2.0])       # 8 configs
    a = run_mpcc_battery(cfg, grid, steps=10)
    mesh = Mesh(np.array(jax.devices()[:8]), ("cfg",))
    b = run_mpcc_battery(cfg, grid, steps=10, mesh=mesh)
    np.testing.assert_allclose(a.s_hist, b.s_hist, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(a.feasible_frac > 0.9,
                                  b.feasible_frac > 0.9)


def test_sqp_fails_counts_inaccurate_solves():
    """The reference increments n_no_solves_sqp_ for ANY solver status
    != 0 — including accepted status-1 (inaccurate) solves whose update IS
    applied (mpc.cpp:239-244). A finite-but-unconverged QP must therefore
    count toward sqp_fails (driving the driver's n_reset ladder) while
    still being mixed into the iterate."""
    track = make_track("oval_mt")
    # a static at-speed guess violates the dynamics rows: the first SQP
    # iteration's 1-step ADMM solve is finite but above tolerance (it is
    # still mixed in — accepted-inaccurate), later warm-started iterations
    # converge
    x = jnp.zeros(9, jnp.float32).at[0].set(2.0).at[3].set(0.3)
    x_bar = jnp.stack([x] * 21)
    u_bar = jnp.zeros((20, 2), jnp.float32)
    sol = mpcc_solve(track, MPCCGains(), P, 20, 0.05, x, x_bar, u_bar,
                     jnp.zeros(2), sqp_iters=3, admm_iters=1)
    assert bool(np.isfinite(np.asarray(sol.x_pred)).all())
    assert int(sol.sqp_fails) >= 1      # inaccurate solves counted
    # the update was still applied (accepted-inaccurate semantics)
    assert not np.allclose(np.asarray(sol.x_pred), np.asarray(x_bar))
    # with budget every solve converges and nothing counts
    sol_ok = mpcc_solve(track, MPCCGains(), P, 20, 0.05, x, x_bar, u_bar,
                        jnp.zeros(2), sqp_iters=3, admm_iters=400)
    assert bool(sol_ok.feasible) and int(sol_ok.sqp_fails) == 0
