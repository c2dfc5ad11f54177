"""Experiment battery: parameter sweeps as vmapped scenario batches.

The reference runs a SERIAL nested grid over horizons and gains, re-invoking
the full experiment per combination (``planner/scripts/experiment_battery.py``
:15-38 — with an unused ``active_threads = 3`` hinting at intended
concurrency). On device: gain combinations become a vmapped batch axis of
the fleet step — every combination advances simultaneously on one chip (or
sharded over a mesh, BASELINE.json config #5). Horizon sweeps change array
shapes and therefore remain an outer host loop (one compile per N).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from colaborativempc_tpu.config.params import ExperimentConfig, Gains
from colaborativempc_tpu.geometry import Track, make_track
from colaborativempc_tpu.planners.lpv import lpv_solve, LPVSolution
from colaborativempc_tpu.runtime.simulate import (
    FleetState, init_lpv_fleet, _neighbour_index,
)


def gain_grid(base: Gains, q_vx=None, q_ey=None, q_epsi=None,
              dr_scale=None, wq=None) -> list[Gains]:
    """Build the cartesian gain grid (reference sweeps Qvx, Qey, Qew, QdU,
    QU, experiment_battery.py:15-27)."""
    q_vx = q_vx if q_vx is not None else [float(base.q[0])]
    q_ey = q_ey if q_ey is not None else [float(base.q[3])]
    q_epsi = q_epsi if q_epsi is not None else [float(base.q[4])]
    dr_scale = dr_scale if dr_scale is not None else [1.0]
    wq = wq if wq is not None else [base.wq]
    out = []
    for vx, ey, ep, drs, w in itertools.product(q_vx, q_ey, q_epsi,
                                                dr_scale, wq):
        q = np.asarray(base.q).copy()
        q[0], q[3], q[4] = vx, ey, ep
        out.append(Gains(q=jnp.asarray(q), qs=base.qs, r=base.r,
                         dr=base.dr * drs, wq=w))
    return out


class BatteryResult(NamedTuple):
    states: np.ndarray      # (T, n_cfg, n_agents, 9)
    min_dist_exec: np.ndarray  # (T, n_cfg)
    feasible: np.ndarray    # (T, n_cfg, n_agents)
    progress: np.ndarray    # (n_cfg,) final mean s per config
    n_configs: int


def run_lpv_battery(cfg: ExperimentConfig, grid: Sequence[Gains],
                    steps: int, track: Track | None = None) -> BatteryResult:
    """Advance every gain combination in lock-step as one vmapped batch."""
    if track is None:
        track = make_track(cfg.map_type)
    n_cfg = len(grid)
    gains_batch = jax.tree.map(lambda *xs: jnp.stack(
        [jnp.asarray(x, jnp.float32) for x in xs]), *grid)

    ns = jnp.asarray(_neighbour_index(cfg.n_agents))
    multi = cfg.n_agents > 1

    def one_agent(gains, x0, x_lin, u_lin, u_old, w, y, rs, neigh):
        return lpv_solve(
            track, gains, cfg.limits, cfg.model, cfg.N, cfg.dt,
            x0, x_lin, u_lin, u_old, neigh if multi else None,
            w0=w, y0=y, rho_scale0=rs,
            admm_iters=cfg.solver.admm_budget(), rho=cfg.solver.rho,
            alpha_relax=cfg.solver.alpha_relax,
            eps=cfg.solver.eps, lane=cfg.lane)

    def fleet_step(gains, state: FleetState):
        agents_xy = jnp.swapaxes(state.x_pred[:, :, 7:9], 0, 1)
        neigh = jnp.swapaxes(agents_xy[:, ns, :], 0, 1)
        sol: LPVSolution = jax.vmap(
            lambda *a: one_agent(gains, *a))(
            state.x0, state.x_pred, state.u_pred, state.u_old,
            state.w, state.y, state.rho_scale, neigh)
        new_state = FleetState(
            x0=sol.x_pred[:, 1, :], x_pred=sol.x_pred, u_pred=sol.u_pred,
            u_old=sol.u_pred[:, 0, :], w=sol.w, y=sol.y,
            rho_scale=sol.rho_scale,
            lane=state.lane, hold_count=state.hold_count,
            brake_count=state.brake_count, jam_count=state.jam_count)
        pe = sol.x_pred[:, 1, 7:9]
        de = jnp.sqrt(jnp.sum((pe[:, None] - pe[None, :]) ** 2, axis=-1)
                      + 1e-12) + jnp.eye(pe.shape[0]) * 1e9
        return new_state, (jnp.min(de), sol.feasible)

    # the whole sweep is ONE device program: every gain combination
    # advances through all `steps` inside a single scanned jit call (no
    # per-step host dispatch; cf. simulate.make_lpv_fleet_rollout)
    def sweep_rollout(gains, state: FleetState):
        def body(st, _):
            st2, (min_de, feas) = fleet_step(gains, st)
            return st2, (st2.x0, min_de, feas)
        return jax.lax.scan(body, state, None, length=steps)

    sweep = jax.jit(jax.vmap(sweep_rollout))

    state = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_cfg,) + x.shape).copy(),
        init_lpv_fleet(track, cfg))

    state, (x0_h, min_de_h, feas_h) = sweep(gains_batch, state)
    # (n_cfg, steps, ...) -> (steps, n_cfg, ...) to keep the result schema
    states_h = np.moveaxis(np.asarray(x0_h), 0, 1)
    dist_h = np.moveaxis(np.asarray(min_de_h), 0, 1)
    feas_h = np.moveaxis(np.asarray(feas_h), 0, 1)
    return BatteryResult(
        states=states_h,
        min_dist_exec=np.asarray(dist_h),
        feasible=np.asarray(feas_h),
        progress=states_h[-1, :, :, 6].mean(axis=-1),
        n_configs=n_cfg)


class NLBatteryResult(NamedTuple):
    states: np.ndarray          # (T, n_cfg, n_agents, 9)
    min_dist: np.ndarray        # (T, n_cfg) min predicted pairwise distance
    min_dist_exec: np.ndarray   # (T, n_cfg)
    feasible: np.ndarray        # (T, n_cfg, n_agents)
    ocd_iterations: np.ndarray  # (T, n_cfg) per-step OCD depth per config
    progress: np.ndarray        # (n_cfg,) final mean s per config
    n_configs: int


def run_nl_battery(cfg: ExperimentConfig, grid: Sequence[Gains],
                   steps: int, track: Track | None = None,
                   x0s=None) -> NLBatteryResult:
    """NL-OCD battery: every gain combination advances its full coordination
    loop in lock-step as one vmapped device program.

    The reference sweeps the NL pipeline serially, one full experiment per
    combination (``experiment_battery.py:15-38`` re-invoking
    ``NL_EU_N_main.main``); here the gain axis is a batch axis of the
    scanned OCD rollout. Per-lane convergence freezing (runtime/ocd.py
    ocd_iteration) keeps each config's trajectory and OCD-iteration counts
    identical to a standalone run even though lanes share the while_loop.
    Horizon (N) sweeps change array shapes and stay an outer host loop.
    """
    from colaborativempc_tpu.runtime.ocd import (
        init_nl_fleet, make_nl_ocd_rollout_gains,
    )
    if track is None:
        track = make_track(cfg.map_type)
    n_cfg = len(grid)
    gains_batch = jax.tree.map(lambda *xs: jnp.stack(
        [jnp.asarray(x, jnp.float32) for x in xs]), *grid)

    rollout = make_nl_ocd_rollout_gains(track, cfg, steps)
    sweep = jax.jit(jax.vmap(rollout, in_axes=(0, 0)))

    state = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_cfg,) + x.shape).copy(),
        init_nl_fleet(track, cfg, x0s))

    _, (x0_h, _, m) = sweep(gains_batch, state)
    states_h = np.moveaxis(np.asarray(x0_h), 0, 1)      # (T, n_cfg, n_ag, 9)
    return NLBatteryResult(
        states=states_h,
        min_dist=np.moveaxis(np.asarray(m.min_dist), 0, 1),
        min_dist_exec=np.moveaxis(np.asarray(m.min_dist_exec), 0, 1),
        feasible=np.moveaxis(np.asarray(m.feasible), 0, 1),
        ocd_iterations=np.moveaxis(np.asarray(m.ocd_iterations), 0, 1),
        progress=states_h[-1, :, :, 6].mean(axis=-1),
        n_configs=n_cfg)


# ---------------------------------------------------------------------------
# MPCC racing battery: gain sweeps as a vmapped batch of closed-loop races
# ---------------------------------------------------------------------------

def mpcc_gain_grid(base, q_contour=None, q_progress=None, dr_scale=None):
    """Cartesian grid over the racing trade-off knobs (contouring accuracy
    vs progress reward vs input smoothness) — the reference tunes these by
    hand-editing cost.json and re-running the binary (main.cpp)."""
    from colaborativempc_tpu.planners.mpcc import MPCCGains
    q_contour = q_contour if q_contour is not None else [base.q_contour]
    q_progress = q_progress if q_progress is not None else [base.q_progress]
    dr_scale = dr_scale if dr_scale is not None else [1.0]
    out = []
    for qc, qp, drs in itertools.product(q_contour, q_progress, dr_scale):
        out.append(base._replace(q_contour=float(qc), q_progress=float(qp),
                                 dr_delta=base.dr_delta * drs,
                                 dr_drive=base.dr_drive * drs))
    return out


class MPCCBatteryResult(NamedTuple):
    s_hist: np.ndarray        # (T, n_cfg) progress per step
    vx_hist: np.ndarray       # (T, n_cfg)
    ey_hist: np.ndarray       # (T, n_cfg)
    feasible_frac: np.ndarray  # (n_cfg,)
    resets: np.ndarray        # (n_cfg,) cold-start count (beyond the first)
    progress: np.ndarray      # (n_cfg,) final s
    lap_time: np.ndarray      # (n_cfg,) first-lap time [s]; nan = no lap
    n_configs: int


def run_mpcc_battery(cfg, grid, steps: int,
                     track=None, mesh=None) -> MPCCBatteryResult:
    """Race every gain combination simultaneously: the closed-loop driver
    (warm/cold start, failure reset, RK4 plant — runtime/racing.py) scanned
    over control steps and vmapped over the gain grid, ONE device program.
    The reference tunes its racing controller one serial binary run at a
    time; here a whole tuning grid costs one race's wall time.

    ``mesh``: optional 1-axis ``jax.sharding.Mesh`` — races are embarrassingly
    parallel (no cross-config collectives), so sharding the grid axis over
    devices is pure data-parallel: inputs are placed with a config-axis
    sharding and jit partitions the vmapped program automatically."""
    from colaborativempc_tpu.runtime.racing import (
        _make_mpcc_step_fn, init_mpcc, load_mpcc_track,
    )
    if track is None:
        track = load_mpcc_track(cfg)
    n_cfg = len(grid)
    gains_batch = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]),
        *grid)
    step_fn = _make_mpcc_step_fn(track, cfg)

    def race(gains, state):
        def body(st, _):
            st2, m = step_fn(gains, st)
            return st2, m
        return jax.lax.scan(body, state, None, length=steps)

    state0 = init_mpcc(track, cfg)
    states = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_cfg,) + x.shape).copy(),
        state0)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        axis = mesh.axis_names[0]
        if n_cfg % mesh.devices.size:
            raise ValueError(f"grid size {n_cfg} must divide the mesh "
                             f"({mesh.devices.size} devices)")
        put = lambda x: jax.device_put(  # noqa: E731
            x, NamedSharding(mesh, P(axis, *((None,) * (x.ndim - 1)))))
        gains_batch = jax.tree.map(put, gains_batch)
        states = jax.tree.map(put, states)
    final, metrics = jax.jit(jax.vmap(race))(gains_batch, states)

    s_hist = np.asarray(metrics.s).T           # (T, n_cfg)
    L = float(track.track_length[0])
    lap_time = np.full(n_cfg, np.nan)
    for c in range(n_cfg):
        hit = np.nonzero(s_hist[:, c] >= L)[0]
        if hit.size:
            lap_time[c] = (hit[0] + 1) * cfg.dt
    return MPCCBatteryResult(
        s_hist=s_hist,
        vx_hist=np.asarray(metrics.vx).T,
        ey_hist=np.asarray(metrics.ey).T,
        feasible_frac=np.asarray(metrics.feasible).mean(axis=1),
        resets=np.asarray(metrics.reset).sum(axis=1) - 1,
        progress=np.asarray(final.x[:, 6]),
        lap_time=lap_time,
        n_configs=n_cfg)
