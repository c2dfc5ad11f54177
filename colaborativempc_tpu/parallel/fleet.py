"""Multi-chip sharded fleet execution over a device mesh.

The on-device replacement for the reference's process-per-agent ROS
deployment (``ROS/src/planner_experiments/src/LPV_ROS_main.py``,
``launch/LPV_car_spawner.launch``): agents live on a mesh axis and scenario
batches (Monte-Carlo sweeps, the reference's ``experiment_battery.py``) on a
second axis. The per-step plan exchange that ROS performed over TCPROS
pub/sub with hand-rolled barrier flags (``LPV_ROS_main.py:124-151``) is ONE
``jax.lax.all_gather`` of (X, Y) horizon trajectories over the agent axis —
riding NVLink (an NCCL all-gather) instead of loopback TCP — inside a single jitted SPMD program.

Layout:
    mesh axes ("scen", "agent")
    x_pred: (S, n_agents, N+1, 9) sharded P("scen", "agent")
    one or more agents per device along the agent axis
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from colaborativempc_tpu.config.params import ExperimentConfig, lpv_gains
from colaborativempc_tpu.geometry import Track
from colaborativempc_tpu.planners.lpv import lpv_solve, LPVSolution
from colaborativempc_tpu.runtime.simulate import (
    FleetState, StepMetrics, _apply_exec_beta, _neighbour_index,
    _per_agent_limits, _sep_filter_beta, escalate_holds, hold_vx_scale,
    lateral_wall,
)


def _sharded_lpv_parts(track: Track, cfg: ExperimentConfig,
                       scen_axis: str, agent_axis: str):
    """Shared machinery for the sharded LPV entry points: the shard-local
    one-step body plus the state/metrics partition specs.
    ``make_sharded_lpv_step`` shard_maps the body directly;
    ``make_sharded_lpv_rollout`` wraps it in a ``lax.scan`` INSIDE the
    shard_map so a whole fixed-step experiment is ONE device program.
    """
    gains = cfg.gains if cfg.gains is not None else lpv_gains()
    n_ag = cfg.n_agents
    multi = n_ag > 1
    # full stage-scan unroll for the multi-agent fleet step at short
    # horizons, the same caller-scoped default as the single-device step
    # (runtime/simulate.py make_lpv_fleet_step); it awaits re-measurement
    # on the H100, here and under shard_map (where full unroll also
    # lengthens the first compile). Pin SolverConfig.unroll to override.
    fleet_unroll = cfg.solver.unroll
    if fleet_unroll is None and multi and cfg.N <= 24:
        fleet_unroll = cfg.N
    limits_pa = _per_agent_limits(cfg)  # heterogeneous fleets supported
    ns = jnp.asarray(_neighbour_index(n_ag))

    def one_agent(lane, limits, x0, x_lin, u_lin, u_old, w, y, rho_scale,
                  neighbours_xy, neigh_boost):
        return lpv_solve(
            track, gains, limits, cfg.model, cfg.N, cfg.dt,
            x0, x_lin, u_lin, u_old,
            neighbours_xy if multi else None,
            neigh_boost=neigh_boost if multi else None,
            w0=w, y0=y, rho_scale0=rho_scale,
            admm_iters=cfg.solver.admm_budget(), rho=cfg.solver.rho,
            alpha_relax=cfg.solver.alpha_relax,
            eps=cfg.solver.eps, lane=lane,
            epoch_len=cfg.solver.epoch_len, unroll=fleet_unroll,
            assoc=cfg.solver.assoc)

    def local_step(state: FleetState):
        # local shapes: (S_l, A_l, ...)
        A_l = state.x0.shape[1]
        a_idx = jax.lax.axis_index(agent_axis)

        if cfg.dynamic_lane:
            # per-step lane switch (reference set_lane/checkLane): purely
            # shard-local math — each (scenario, agent) re-localises its
            # own pose, no collectives involved; prev_lane threaded for
            # exact cross-lane lap bookkeeping (geometry/frenet.py)
            from colaborativempc_tpu.geometry import relocalize, select_lane
            lanes, x0_new = jax.vmap(jax.vmap(
                lambda x, pl: select_lane(track, x, prev_lane=pl)))(
                state.x0, state.lane)
            x_pred = jax.vmap(jax.vmap(lambda xs, ln, pl: jax.vmap(
                lambda x: relocalize(track, x, ln, old_lane=pl))(xs)))(
                state.x_pred, lanes, state.lane)
            x_pred = x_pred.at[:, :, 0].set(x0_new)
            state = state._replace(x0=x0_new, x_pred=x_pred, lane=lanes)
        else:
            # derived from the carried lane so the value stays varying
            # over the mesh axes (a bare constant would be replicated
            # and break the scan carry type inside shard_map)
            lanes = state.lane * 0 + cfg.lane

        # recovery feasibility pass: pre-escalation hold-or-brake counts
        # (runtime/simulate.py hold_vx_scale), shard-local
        vxs = hold_vx_scale(
            cfg, jnp.maximum(state.hold_count, state.brake_count),
            state.x0.dtype)

        # recovery escalation ladder (shard-local, runtime/simulate.py)
        state = escalate_holds(track, cfg, state, lanes)

        # THE exchange: gather every agent's (X, Y) plan (NCCL all-gather over NVLink)
        xy_local = state.x_pred[:, :, :, 7:9]          # (S_l, A_l, N+1, 2)
        all_xy = jax.lax.all_gather(
            xy_local, agent_axis, axis=1, tiled=True)  # (S_l, n_ag, N+1, 2)
        # hold flags ride the same exchange (stale-broadcast hardening:
        # push harder against plan-holding neighbours, cfg.hold_sep_boost)
        boost_sc = cfg.hold_sep_boost if cfg.hold_on_infeasible else 0.0
        hold_local = (state.hold_count > 0).astype(xy_local.dtype) * boost_sc
        all_hold = jax.lax.all_gather(
            hold_local, agent_axis, axis=1, tiled=True)   # (S_l, n_ag)

        def neighbours_of(global_id, all_xy_s):
            # all agents except global_id, in the single-device step's
            # order (ascending ids), so both lay out the neighbour rows
            # and their warm starts alike
            return all_xy_s[ns[global_id]]             # (n_nb, N+1, 2)

        def solve_scenario(x0, x_lin, u_lin, u_old, w, y, rs, all_xy_s,
                           all_hold_s, lanes_s, vxs_s):
            def solve_agent(local_a, x0a, xla, ula, uoa, wa, ya, rsa, ln,
                            vxsa):
                gid = a_idx * A_l + local_a
                lim_a = jax.tree.map(lambda v: v[gid], limits_pa)
                lim_a = lim_a._replace(vx_ref=lim_a.vx_ref * vxsa)
                nb = jnp.swapaxes(neighbours_of(gid, all_xy_s), 0, 1)
                nb_boost = neighbours_of(gid, all_hold_s)  # (n_nb,)
                return one_agent(ln, lim_a, x0a, xla, ula, uoa, wa, ya,
                                 rsa, nb, nb_boost)
            return jax.vmap(solve_agent)(
                jnp.arange(A_l), x0, x_lin, u_lin, u_old, w, y, rs, lanes_s,
                vxs_s)

        sol: LPVSolution = jax.vmap(solve_scenario)(
            state.x0, state.x_pred, state.u_pred, state.u_old,
            state.w, state.y, state.rho_scale, all_xy, all_hold, lanes,
            vxs)

        jam_count = jnp.where(sol.feasible, 0, state.jam_count + 1)
        if cfg.hold_on_infeasible:
            # solver-failure containment, identical semantics to the
            # single-device step (runtime/simulate.py): an unconverged
            # plan is not executed — shift-hold the previous one —
            # until the degraded-execution escape (cfg.hold_exec_k)
            # fires. Purely shard-local (per scenario x agent).
            ok = sol.feasible                          # (S_l, A_l)
            degraded = jnp.zeros_like(ok)
            if cfg.hold_exec_k is not None:
                finite = (jnp.all(jnp.isfinite(sol.x_pred), axis=(2, 3))
                          & jnp.all(jnp.isfinite(sol.u_pred), axis=(2, 3)))
                degraded = ((~ok) & finite
                            & (state.jam_count >= cfg.hold_exec_k))
                ok = ok | degraded
            ok4 = ok[:, :, None, None]
            hold_x = jnp.concatenate(
                [state.x_pred[:, :, 1:], state.x_pred[:, :, -1:]], axis=2)
            hold_u = jnp.concatenate(
                [state.u_pred[:, :, 1:], state.u_pred[:, :, -1:]], axis=2)
            x_pred = jnp.where(ok4, sol.x_pred, hold_x)
            u_pred = jnp.where(ok4, sol.u_pred, hold_u)
            w = jnp.where(ok4, sol.w, state.w)
            y = jnp.where(ok4, sol.y, state.y)
            rho_scale = jnp.where(ok[:, :, None], sol.rho_scale,
                                  state.rho_scale)
            hold_count = jnp.where(sol.feasible, 0, state.hold_count + 1)
        else:
            x_pred, u_pred = sol.x_pred, sol.u_pred
            w, y, rho_scale = sol.w, sol.y, sol.rho_scale
            hold_count = state.hold_count
            degraded = jnp.zeros(sol.feasible.shape, bool)

        # executed-separation safety filter: betas need full-fleet pairwise
        # geometry, so the standstill anchors and executed candidates ride
        # one extra (tiny) all_gather; the projection itself is applied
        # shard-locally to this shard's agents. Identical semantics to the
        # single-device step (runtime/simulate.py): the physical
        # execution envelope (kinematic bounds + track-limits wall,
        # shard-local), then the separation filter on the enveloped
        # candidates.
        cand_local, wall_clip = lateral_wall(track, cfg, state.x0,
                                             x_pred[:, :, 1, :], lanes)
        if cfg.exec_sep_frac is not None:
            anchors = jax.lax.all_gather(
                state.x0, agent_axis, axis=1, tiled=True)   # (S_l, n_ag, 9)
            cands = jax.lax.all_gather(
                cand_local, agent_axis, axis=1, tiled=True)
            dth = jnp.max(jnp.asarray(cfg.limits.min_dist))
            floor = jnp.asarray(cfg.exec_sep_frac, cands.dtype) * dth
            beta_full = jax.vmap(
                lambda p0, p1, pr: _sep_filter_beta(p0, p1, floor,
                                                    prio=pr))(
                anchors[..., 7:9], cands[..., 7:9],
                anchors[..., 6])                            # (S_l, n_ag)
            beta_full = jax.lax.pmean(beta_full, agent_axis)
            gids = a_idx * A_l + jnp.arange(A_l)
            beta_local = beta_full[:, gids]
            x0_exec = _apply_exec_beta(state.x0, cand_local, beta_local)
            exec_full = _apply_exec_beta(anchors, cands, beta_full)
        else:
            beta_local = jnp.ones(cand_local.shape[:2], cand_local.dtype)
            x0_exec = cand_local
            exec_full = None

        brake_count = jnp.where(beta_local < 1.0, state.brake_count + 1,
                                jnp.zeros_like(state.brake_count))
        new_state = FleetState(
            x0=x0_exec,
            x_pred=x_pred, u_pred=u_pred,
            u_old=u_pred[:, :, 0, :],
            w=w, y=y, rho_scale=rho_scale,
            lane=lanes, hold_count=hold_count, brake_count=brake_count,
            jam_count=jam_count)

        # fleet-wide min pairwise distance per scenario: reduce over agents
        all_xy_new = jax.lax.all_gather(
            x_pred[:, :, :, 7:9], agent_axis, axis=1, tiled=True)
        p = all_xy_new[:, :, 1:, :]                    # (S_l, n_ag, N, 2)
        diff = p[:, :, None] - p[:, None, :]
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-12)
        eye = jnp.eye(n_ag)[None, :, :, None] * 1e9
        min_dist = jnp.min(dist + eye, axis=(1, 2, 3))  # (S_l,)
        # every agent shard computed the same value; pmin makes the
        # replication explicit so the P("scen") out_spec typechecks
        min_dist = jax.lax.pmin(min_dist, agent_axis)

        if exec_full is not None:
            exec_xy = exec_full[..., 7:9]              # filtered positions
        else:
            exec_xy = jax.lax.all_gather(
                cand_local[..., 7:9], agent_axis, axis=1, tiled=True)
        dd = exec_xy[:, :, None, :] - exec_xy[:, None, :, :]
        dexec = jnp.sqrt(jnp.sum(dd * dd, axis=-1) + 1e-12)
        dexec = dexec + jnp.eye(n_ag)[None] * 1e9
        min_dist_exec = jax.lax.pmin(jnp.min(dexec, axis=(1, 2)), agent_axis)
        metrics = StepMetrics(
            feasible=sol.feasible, iterations=sol.iterations,
            r_prim=sol.r_prim, min_dist=min_dist,
            min_dist_exec=min_dist_exec,
            slack_max=jnp.max(jnp.abs(sol.s_pred), axis=(2, 3)),
            exec_beta=beta_local, wall_clip=wall_clip)
        return new_state, metrics

    state_spec = FleetState(
        x0=P(scen_axis, agent_axis), x_pred=P(scen_axis, agent_axis),
        u_pred=P(scen_axis, agent_axis), u_old=P(scen_axis, agent_axis),
        w=P(scen_axis, agent_axis), y=P(scen_axis, agent_axis),
        rho_scale=P(scen_axis, agent_axis),
        lane=P(scen_axis, agent_axis),
        hold_count=P(scen_axis, agent_axis),
        brake_count=P(scen_axis, agent_axis),
        jam_count=P(scen_axis, agent_axis))
    metrics_spec = StepMetrics(
        feasible=P(scen_axis, agent_axis),
        iterations=P(scen_axis, agent_axis),
        r_prim=P(scen_axis, agent_axis),
        min_dist=P(scen_axis),
        min_dist_exec=P(scen_axis),
        slack_max=P(scen_axis, agent_axis),
        exec_beta=P(scen_axis, agent_axis),
        wall_clip=P(scen_axis, agent_axis))
    return local_step, state_spec, metrics_spec


def make_sharded_lpv_step(track: Track, cfg: ExperimentConfig, mesh: Mesh,
                          scen_axis: str = "scen",
                          agent_axis: str = "agent"):
    """Build the sharded one-control-step function for batched fleets.

    Operates on a scenario-batched FleetState whose arrays carry a leading
    scenario dimension: x0 (S, n_ag, 9), x_pred (S, n_ag, N+1, 9), ...
    Returns a jitted function state -> (state, metrics).
    """
    local_step, state_spec, metrics_spec = _sharded_lpv_parts(
        track, cfg, scen_axis, agent_axis)
    sharded = jax.shard_map(local_step, mesh=mesh,
                            in_specs=(state_spec,),
                            out_specs=(state_spec, metrics_spec))
    return jax.jit(sharded)


def make_sharded_lpv_rollout(track: Track, cfg: ExperimentConfig, mesh: Mesh,
                             steps: int,
                             scen_axis: str = "scen",
                             agent_axis: str = "agent"):
    """Fixed-step sharded closed-loop rollout: ``lax.scan`` over control
    steps INSIDE the shard_map, so a multi-chip Monte-Carlo/battery chunk is
    ONE device program with no host dispatch between steps — the sharded
    twin of ``runtime.simulate.make_lpv_fleet_rollout`` (round-2 verdict:
    per-step sharded loops paid one dispatch per control step, exactly the
    cost the scanned rollouts were built to remove).

    Returns a jitted ``state -> (final_state, metrics)`` with ``(steps,
    ...)`` leading time axes on the metrics (time is unsharded: the metric
    specs gain a leading None).
    """
    local_step, state_spec, metrics_spec = _sharded_lpv_parts(
        track, cfg, scen_axis, agent_axis)

    def local_roll(state: FleetState):
        def body(st, _):
            st2, m = local_step(st)
            return st2, m
        return jax.lax.scan(body, state, None, length=steps)

    scan_metrics_spec = jax.tree.map(
        lambda spec: P(*((None,) + tuple(spec))), metrics_spec,
        is_leaf=lambda x: isinstance(x, P))
    sharded = jax.shard_map(local_roll, mesh=mesh,
                            in_specs=(state_spec,),
                            out_specs=(state_spec, scan_metrics_spec))
    return jax.jit(sharded)


def batch_fleet_state(state: FleetState, n_scen: int) -> FleetState:
    """Tile a single-fleet state into a scenario batch (leading S axis)."""
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_scen,) + x.shape).copy()
        if hasattr(x, "shape") else x, state)


def shard_fleet_state(state: FleetState, mesh: Mesh,
                      scen_axis: str = "scen",
                      agent_axis: str = "agent") -> FleetState:
    """Place a scenario-batched FleetState onto the mesh."""
    def put(x):
        spec = P(scen_axis, agent_axis)
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, state)
