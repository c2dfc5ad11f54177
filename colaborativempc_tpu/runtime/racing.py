"""Closed-loop MPCC racing runtime: the reference's MPC driver + sim entry.

Library twin of ``Matlab-tests/MPCC-master/C++/MPC/mpc.cpp`` runMPC
(:219-259) and the ``main.cpp`` closed-loop sim (:30-86), productised the
way ``run_lpv_experiment``/``run_nl_experiment`` run the other planner
families: ONE jitted control step does spline re-projection + s-unwrap
(mpc.cpp:223-224), warm-start shift with RK4 tail (updateInitialGuess,
:135-150) or cold start from the track (generateNewInitialGuess, :175-196)
selected by a traced validity flag, the SQP solve with normalisation
(planners/mpcc.py), solver-failure bookkeeping with guess reset
(:231-252), and the RK4 plant step (integrator.cpp simTimeStep :55-68) —
the host loop only handles termination and IO.

Unlike the collaborative planners (whose plant is the prediction,
LPV_HP_N_main.py:106), this closed loop matches the reference MPCC: the
plant is the full nonlinear Pacejka model integrated with fine RK4
sub-steps, so model-mismatch between the SQP linearisation and the plant is
exercised every step.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from colaborativempc_tpu.dynamics.pacejka import f_continuous_pacejka
from colaborativempc_tpu.geometry import (
    Track, make_track, curvature, frenet_to_cartesian, project_on_spline,
    track_from_json, wrap_s, wrap_to_pi,
)
from colaborativempc_tpu.planners.mpcc import (
    MPCCConfig, MPCCSolution, mpcc_solve,
)


class MPCCState(NamedTuple):
    """Racing-driver state carried across control steps (mpc.h:104-118:
    initial_guess_, valid_initial_guess_, n_non_solves_)."""
    x: jnp.ndarray            # (9,) plant state
    x_bar: jnp.ndarray        # (N+1, 9) initial guess / last solution
    u_bar: jnp.ndarray        # (N, 2)
    u_old: jnp.ndarray        # (2,) last applied input
    w: jnp.ndarray            # (N, 7) ADMM warm starts
    y: jnp.ndarray            # (N, 7)
    rho_scale: jnp.ndarray    # (7,)
    valid_guess: jnp.ndarray  # () bool
    n_non_solves: jnp.ndarray  # () int32 consecutive failed control steps


class MPCCStepMetrics(NamedTuple):
    feasible: jnp.ndarray     # last-SQP-iteration QP within tolerance
    r_prim: jnp.ndarray
    iterations: jnp.ndarray   # total ADMM iterations across SQP iterations
    sqp_fails: jnp.ndarray    # rejected (non-finite) QP solves this step
    reset: jnp.ndarray        # guess was regenerated from the track
    s: jnp.ndarray            # unwrapped progress after the step
    vx: jnp.ndarray
    ey: jnp.ndarray


def _relocalize_unwrapped(track: Track, x: jnp.ndarray) -> jnp.ndarray:
    """Project the pose onto the track and refresh (s, ey, epsi), keeping s
    UNWRAPPED (cumulative across laps).

    The reference's ``x0.s = track_.porjectOnSpline(x0); x0.unwrap(L)``
    (mpc.cpp:223-224): the Newton projection is warm-started from the
    previous s and the result re-attached to the lap count nearest the
    previous s, so progress stays monotone for lap counting while geometry
    lookups wrap internally.
    """
    s_prev = x[6]
    L = track.track_length[0]
    s_proj = project_on_spline(track, x[7], x[8], wrap_s(track, s_prev))
    ds = s_proj - wrap_s(track, s_prev)
    # shortest signed wrap-aware increment (closed tracks only)
    ds = jnp.where(track.open_flag, ds,
                   jnp.where(ds > L / 2, ds - L,
                             jnp.where(ds < -L / 2, ds + L, ds)))
    s_new = s_prev + ds
    # exact local frame at the projected point
    px, py, theta_t = frenet_to_cartesian(track, s_new, 0.0)
    n_hat = jnp.stack([-jnp.sin(theta_t), jnp.cos(theta_t)])
    ey = (x[7] - px) * n_hat[0] + (x[8] - py) * n_hat[1]
    epsi = wrap_to_pi(x[5] - theta_t)
    return x.at[3].set(ey).at[4].set(epsi).at[6].set(s_new)


def _warm_guess(track: Track, cfg: MPCCConfig, x0: jnp.ndarray,
                x_bar: jnp.ndarray, u_bar: jnp.ndarray):
    """Shift the previous solution one stage and append an RK4 tail
    (``updateInitialGuess``, mpc.cpp:135-150); stage 0 pinned to the
    measured state. s stays continuous by construction (the dynamics
    integrate it cumulatively), which is what unwrapInitialGuess
    (:153-173) restores in the reference's wrapped representation."""
    dt = cfg.dt
    kap_last = curvature(track, x_bar[-1, 6])
    tail = x_bar[-1] + dt * f_continuous_pacejka(
        x_bar[-1], jnp.zeros(2, x_bar.dtype), kap_last, cfg.model)
    x_new = jnp.concatenate([x0[None], x_bar[2:], tail[None]])
    u_new = jnp.concatenate([u_bar[1:], jnp.zeros((1, 2), u_bar.dtype)])
    return x_new, u_new


def _cold_guess(track: Track, cfg: MPCCConfig, x0: jnp.ndarray):
    """Generate a fresh guess rolling along the centerline at
    ``initial_velocity`` from the projected pose
    (``generateNewInitialGuess``, mpc.cpp:175-196), with the heading
    unwrapped along the horizon (unwrapInitialGuess)."""
    dt = cfg.dt
    v0 = jnp.asarray(cfg.initial_velocity, x0.dtype)
    N = cfg.N
    ks = jnp.arange(N + 1, dtype=x0.dtype)
    ss = x0[6] + ks * dt * v0
    px, py, th = jax.vmap(lambda s: frenet_to_cartesian(track, s, 0.0))(ss)
    # cumulative unwrap: theta continuous along the horizon, anchored at
    # the track tangent of stage 0
    dth = wrap_to_pi(jnp.diff(th))
    th_unwrapped = th[0] + jnp.concatenate(
        [jnp.zeros(1, x0.dtype), jnp.cumsum(dth)])
    x_new = jnp.zeros((N + 1, 9), x0.dtype)
    x_new = x_new.at[:, 0].set(v0)
    x_new = x_new.at[:, 5].set(th_unwrapped)
    x_new = x_new.at[:, 6].set(ss)
    x_new = x_new.at[:, 7].set(px)
    x_new = x_new.at[:, 8].set(py)
    # stage 0 is the measured state exactly (guess[0].xk = x0,
    # mpc.cpp:177); theta multiples need no reconciliation — it enters the
    # dynamics/cost only through sin/cos
    x_new = x_new.at[0].set(x0)
    u_new = jnp.zeros((N, 2), x0.dtype)
    return x_new, u_new


def _plant_rk4(track: Track, cfg: MPCCConfig, x: jnp.ndarray,
               u: jnp.ndarray) -> jnp.ndarray:
    """Integrate the full nonlinear Pacejka plant over one control period
    with fine RK4 sub-steps (``Integrator::simTimeStep``,
    integrator.cpp:55-68), curvature re-evaluated per sub-step."""
    h = cfg.dt / cfg.plant_substeps

    def sub(x, _):
        def f(xx):
            return f_continuous_pacejka(
                xx, u, curvature(track, xx[6]), cfg.model)
        k1 = f(x)
        k2 = f(x + 0.5 * h * k1)
        k3 = f(x + 0.5 * h * k2)
        k4 = f(x + h * k3)
        return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None

    x_new, _ = jax.lax.scan(sub, x, None, length=cfg.plant_substeps)
    return x_new


def _make_mpcc_step_fn(track: Track, cfg: MPCCConfig):
    """The one-control-step body with the racing GAINS as a traced argument
    ``(gains, state) -> (state, metrics)`` — lets gain sweeps become a
    vmapped batch axis (run_mpcc_battery) while ``make_mpcc_step`` closes
    over the config's gains for the single-race driver."""
    norm = cfg.normalization()
    hard_fail_thresh = max(cfg.n_sqp - 1, 1)   # mpc.cpp:244

    def step(gains: MPCCGains, state: MPCCState):
        x0 = _relocalize_unwrapped(track, state.x)

        x_bar, u_bar = jax.lax.cond(
            state.valid_guess,
            lambda: _warm_guess(track, cfg, x0, state.x_bar, state.u_bar),
            lambda: _cold_guess(track, cfg, x0))
        # a cold start also resets the ADMM warm starts (new geometry)
        w0 = jnp.where(state.valid_guess, state.w, jnp.zeros_like(state.w))
        y0 = jnp.where(state.valid_guess, state.y, jnp.zeros_like(state.y))
        rs0 = jnp.where(state.valid_guess, state.rho_scale,
                        jnp.ones_like(state.rho_scale))

        sol: MPCCSolution = mpcc_solve(
            track, gains, cfg.model, cfg.N, cfg.dt,
            x0, x_bar, u_bar, state.u_old,
            sqp_iters=cfg.n_sqp, sqp_mix=cfg.sqp_mixing,
            admm_iters=cfg.admm_iters, rho=cfg.rho,
            bounds=cfg.bounds, norm=norm,
            w0=w0, y0=y0, rho_scale0=rs0,
            # N>=48 latency schedule (blocked-assoc + epoch 15) measured
            # 1.5x at the reference's N=60 (bench_suite --mpcc-assoc)
            epoch_len=cfg.resolved_epoch_len(), unroll=cfg.unroll,
            assoc=cfg.resolved_assoc())

        finite = (jnp.all(jnp.isfinite(sol.x_pred))
                  & jnp.all(jnp.isfinite(sol.u_pred)))
        # failure bookkeeping (mpc.cpp:231-252): a control step whose SQP
        # loop rejected (nearly) every QP counts as a non-solve; n_reset
        # consecutive non-solves invalidate the guess -> cold start next step
        hard_fail = (~finite) | (sol.sqp_fails >= hard_fail_thresh)
        n_non = jnp.where(hard_fail, state.n_non_solves + 1,
                          jnp.zeros_like(state.n_non_solves))
        valid_next = finite & (n_non < cfg.n_reset)

        x_keep = jnp.where(finite, sol.x_pred, x_bar)
        u_keep = jnp.where(finite, sol.u_pred, u_bar)
        # on a rejected solve the reference returns the SHIFTED previous
        # plan's first input (runMPC returns initial_guess_[0].uk,
        # mpc.cpp:255-258), not zero torque/steer at speed — u_bar[0] is
        # exactly that shifted input (or the cold guess's zero input after
        # a reset), so failure steps follow the held plan
        u0 = jnp.where(finite, sol.u_pred[0], u_bar[0])
        x_next = _plant_rk4(track, cfg, x0, u0)

        new_state = MPCCState(
            x=x_next, x_bar=x_keep, u_bar=u_keep, u_old=u0,
            w=jnp.where(finite, sol.w, w0),
            y=jnp.where(finite, sol.y, y0),
            rho_scale=jnp.where(finite, sol.rho_scale, rs0),
            valid_guess=valid_next, n_non_solves=n_non)
        metrics = MPCCStepMetrics(
            feasible=sol.feasible, r_prim=sol.r_prim,
            iterations=sol.iterations, sqp_fails=sol.sqp_fails,
            reset=~state.valid_guess,
            s=x_next[6], vx=x_next[0], ey=x_next[3])
        return new_state, metrics

    return step


def make_mpcc_step(track: Track, cfg: MPCCConfig):
    """Build the jitted one-control-step function:
    ``MPCCState -> (MPCCState, MPCCStepMetrics)`` (the body of
    mpc.cpp runMPC + one main.cpp sim step)."""
    step_fn = _make_mpcc_step_fn(track, cfg)
    return jax.jit(lambda state: step_fn(cfg.gains, state))


def make_mpcc_rollout(track: Track, cfg: MPCCConfig, steps: int):
    """Fixed-step fully-on-device closed-loop race: ``lax.scan`` over
    control steps (the on-device twin of ``make_lpv_fleet_rollout`` for
    the racing planner; vmap it for batched gain/track sweeps)."""
    step = make_mpcc_step(track, cfg)

    def rollout(state: MPCCState):
        def body(st, _):
            st2, m = step(st)
            return st2, m
        return jax.lax.scan(body, state, None, length=steps)

    return jax.jit(rollout)


def init_mpcc(track: Track, cfg: MPCCConfig,
              x0: Optional[np.ndarray] = None) -> MPCCState:
    """Initial driver state: pose on the track start (or the given state),
    INVALID guess so the first step cold-starts (mpc.cpp valid_initial_
    guess_=false until generateNewInitialGuess runs)."""
    dtype = jnp.float32
    if x0 is None:
        px, py, th = frenet_to_cartesian(track, 0.0, 0.0)
        x0 = jnp.zeros(9, dtype)
        x0 = x0.at[0].set(cfg.initial_velocity)
        x0 = x0.at[5].set(th).at[7].set(px).at[8].set(py)
    x0 = jnp.asarray(x0, dtype)
    N = cfg.N
    return MPCCState(
        x=x0,
        x_bar=jnp.broadcast_to(x0, (N + 1, 9)).copy(),
        u_bar=jnp.zeros((N, 2), dtype),
        u_old=jnp.zeros(2, dtype),
        w=jnp.zeros((N, 7), dtype), y=jnp.zeros((N, 7), dtype),
        rho_scale=jnp.ones(7, dtype),
        valid_guess=jnp.asarray(False),
        n_non_solves=jnp.asarray(0, jnp.int32))


class MPCCResult(NamedTuple):
    states: np.ndarray       # (T, 9) plant states
    inputs: np.ndarray       # (T, 2)
    feasible: np.ndarray     # (T,)
    resets: np.ndarray       # (T,) steps that cold-started
    step_times: np.ndarray   # (T,) wall clock
    iterations: np.ndarray   # (T,) ADMM iterations
    steps: int
    finished: bool           # laps completed (when cfg.laps > 0)
    lap_time: Optional[float]  # first-lap time [s] when a lap completed


def load_mpcc_track(cfg: MPCCConfig) -> Track:
    """Track for a config: fitted from the reference JSON when given
    (geometry/spline.py), else the named analytic track."""
    if cfg.track_json is not None:
        return track_from_json(cfg.track_json)
    return make_track(cfg.map_type)


def run_mpcc_experiment(cfg: MPCCConfig,
                        track: Optional[Track] = None,
                        x0: Optional[np.ndarray] = None) -> MPCCResult:
    """Closed-loop race (reference ``main.cpp:30-86``): build the driver,
    run ``n_sim`` control steps (terminating early after ``cfg.laps`` laps
    when set), report solve-time statistics, optionally persist the
    reference CSV schema (states.dat / u.dat / time.dat under
    ``cfg.path``)."""
    if track is None:
        track = load_mpcc_track(cfg)
    state = init_mpcc(track, cfg, x0)
    step = make_mpcc_step(track, cfg)
    L = float(track.track_length[0])

    states, inputs, feas, resets, times, iters = [], [], [], [], [], []
    finished = False
    lap_time = None
    for it in range(cfg.n_sim):
        t0 = time.time()
        state, metrics = step(state)
        state = jax.block_until_ready(state)
        times.append(time.time() - t0)
        states.append(np.asarray(state.x))
        inputs.append(np.asarray(state.u_old))
        feas.append(bool(metrics.feasible))
        resets.append(bool(metrics.reset))
        iters.append(int(metrics.iterations))
        if not np.all(np.isfinite(states[-1])):
            break
        s_now = float(state.x[6])
        if lap_time is None and s_now >= L:
            lap_time = (it + 1) * cfg.dt
        if cfg.verb >= 1 and (it % 50 == 0 or it == cfg.n_sim - 1):
            print(f"[mpcc {it}] s={s_now:.2f} vx={float(state.x[0]):.2f} "
                  f"ey={float(state.x[3]):.3f} "
                  f"iters={iters[-1]} {times[-1] * 1e3:.1f}ms")
        if cfg.laps > 0 and s_now >= cfg.laps * L:
            finished = True
            break

    result = MPCCResult(
        states=np.asarray(states), inputs=np.asarray(inputs),
        feasible=np.asarray(feas), resets=np.asarray(resets),
        step_times=np.asarray(times), iterations=np.asarray(iters),
        steps=len(states), finished=finished, lap_time=lap_time)
    if cfg.save_data:
        save_mpcc_result(cfg, result)
    if cfg.verb >= 1 and len(times) > 3:
        warm = np.asarray(times[3:])
        print(f"mean solve {warm.mean() * 1e3:.1f} ms  "
              f"max {warm.max() * 1e3:.1f} ms")   # main.cpp:75-84 report
    return result


def save_mpcc_result(cfg: MPCCConfig, res: MPCCResult) -> None:
    """Persist the single-agent reference CSV schema (states.dat, u.dat,
    time.dat under <path>/csv/0/, base_class.py:64-99 layout)."""
    d = os.path.join(cfg.path, "csv", "0")
    os.makedirs(d, exist_ok=True)
    np.savetxt(os.path.join(d, "states.dat"), res.states, fmt="%0.5f")
    np.savetxt(os.path.join(d, "u.dat"), res.inputs, fmt="%0.5f")
    np.savetxt(os.path.join(d, "time.dat"), res.step_times, fmt="%0.5f")
