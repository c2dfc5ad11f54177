"""OCD (Optimality Condition Decomposition) dual coordination runtime.

The reference implements this loop three times over — in-process
(``planner/scripts/NL_EU_N_main.py:100-168``, ``NL_HP_N_main.py:98-163``)
and asynchronously over ROS flags (``OCD_ROS_main.py:172-241``). Here it is
a first-class library component: ONE jitted ``lax.while_loop`` whose body
runs all agents' SQP solves (vmapped; shard_map over a mesh for multi-chip),
exchanges trajectories (tensor transpose / all_gather), applies the dual
ascent lambda += alpha * (dth - dist) on master pairs
(``NL_EU_N_main.py:130-139``, alpha = 0.25 from ``NL/config.py:5-8``), and
tests convergence exactly like the reference: all agents' trajectories
within atol for ``it_conv`` consecutive iterations, at least ``min_it_ocd``
iterations, capped at ``max_it_ocd`` (``NL_EU_N_main.py:141-162``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from colaborativempc_tpu.config.params import ExperimentConfig, nl_gains
from colaborativempc_tpu.geometry import (
    Track, make_track, check_end, check_lane, relocalize, select_lane,
)
from colaborativempc_tpu.planners.nl import nl_solve, NLSolution
from colaborativempc_tpu.runtime.simulate import _neighbour_index
from colaborativempc_tpu.utils.warmstart import initialise_agents
from colaborativempc_tpu.config.params import x0_database


class OCDFleetState(NamedTuple):
    """Carried across control steps."""
    x0: jnp.ndarray        # (n_ag, 9)
    x_pred: jnp.ndarray    # (n_ag, N+1, 9)
    u_pred: jnp.ndarray    # (n_ag, N, 2)
    u_old: jnp.ndarray     # (n_ag, 2)
    lambdas: jnp.ndarray   # (n_ag, n_ag, N) coupling prices (persist!)
    w: jnp.ndarray         # (n_ag, N, m)
    y: jnp.ndarray
    rho_scale: jnp.ndarray
    lane: jnp.ndarray      # (n_ag,) int32 lane each x0's Frenet row lives on
    hold_count: jnp.ndarray  # (n_ag,) int32 consecutive plan-holds (ladder)
    brake_count: jnp.ndarray  # (n_ag,) int32 consecutive separation-filter
    #   brakings (simulate.FleetState.brake_count; carried for parity and
    #   observability — the NL stressed studies complete with ~zero holds
    #   so the vx ramp is not wired into the OCD solve)
    jam_count: jnp.ndarray    # (n_ag,) int32 consecutive infeasible
    #   solves (simulate.FleetState.jam_count; drives the
    #   degraded-execution escape, cfg.hold_exec_k)


class _OCDLoopState(NamedTuple):
    x_pred: jnp.ndarray
    u_pred: jnp.ndarray
    x_old: jnp.ndarray
    lambdas: jnp.ndarray
    alpha: jnp.ndarray    # per-(pair, stage) dual step (adaptive_alpha)
    g_prev: jnp.ndarray   # previous residual dth - dist (sign memory)
    planes: jnp.ndarray   # (.., n_ag, n_ag, N, 2) pair planes (hp_opt);
    #                       canonical slot (i, j) with i < j holds (theta, b)
    w: jnp.ndarray
    y: jnp.ndarray
    rho_scale: jnp.ndarray
    it_ocd: jnp.ndarray
    conv_count: jnp.ndarray
    finished: jnp.ndarray
    feasible: jnp.ndarray


def _bisector_planes(x_pred: jnp.ndarray) -> jnp.ndarray:
    """Initial canonical pair planes from the incumbent trajectories.

    For pair (i, j), i < j: normal a = unit(p_j - p_i) (master -> slave),
    offset b = -a.mid — the reference master's geometric initialisation
    (NL_Planner_Hp.py falls back to hyperplane_separator when no planes are
    carried; compute_plane.py:41-68). Returns (n_ag, n_ag, N, 2) of
    (theta, b); only i < j slots are meaningful.
    """
    p = x_pred[:, 1:, 7:9]                               # (n_ag, N, 2)
    diff = p[None, :, :, :] - p[:, None, :, :]           # (i, j, N, 2): j - i
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-9)
    a = diff / dist[..., None]
    theta = jnp.arctan2(a[..., 1], a[..., 0])
    mid = 0.5 * (p[None, :, :, :] + p[:, None, :, :])
    b = -jnp.sum(a * mid, axis=-1)
    return jnp.stack([theta, b], axis=-1)                # (i, j, N, 2)


def _dual_step(ocd, st: _OCDLoopState, g: jnp.ndarray):
    """One dual-ascent step on the coupling prices.

    Fixed step (reference ``lambdas += alpha*cost``, NL_EU_N_main.py:138-139)
    or, when ``ocd.adaptive_alpha``, an RPROP-style per-element step: grow
    while the residual g = dth - dist keeps its sign between iterations
    (price ramping too slowly), shrink when it flips (overshoot). The first
    iteration has g_prev = 0, so the step starts at the configured alpha.

    The update is projected onto [ocd.lambda_lo, inf) — see the OCDConfig
    docstring for why the reference's unprojected duals diverge.
    """
    if not ocd.adaptive_alpha:
        lam = st.lambdas + ocd.alpha * g
        alpha = st.alpha
    else:
        corr = g * st.g_prev
        mult = jnp.where(corr > 0, ocd.alpha_grow,
                         jnp.where(corr < 0, ocd.alpha_shrink, 1.0))
        alpha = jnp.clip(st.alpha * mult,
                         ocd.alpha / ocd.alpha_span,
                         ocd.alpha * ocd.alpha_span)
        lam = st.lambdas + alpha * g
    if ocd.lambda_lo is not None and ocd.lambda_lo > -jnp.inf:
        lam = jnp.maximum(lam, jnp.asarray(ocd.lambda_lo, lam.dtype))
    return lam, alpha


class OCDStepMetrics(NamedTuple):
    ocd_iterations: jnp.ndarray  # scalar: inner iterations this step
    feasible: jnp.ndarray        # (n_ag,)
    min_dist: jnp.ndarray        # min predicted pairwise distance
    min_dist_exec: jnp.ndarray   # min executed pairwise distance
    lambda_max: jnp.ndarray      # max |lambda|
    exec_beta: jnp.ndarray       # (n_ag,) separation-filter advance
    #                              fraction (1.0 = inactive)
    wall_clip: jnp.ndarray       # (n_ag,) track-limits wall clamps


def _contain_nonfinite(st: _OCDLoopState, sol):
    """Per-agent containment of non-finite sub-problem solutions.

    An agent whose SQP/ADMM solve produced inf/NaN (extreme jam states can
    overflow the float32 Riccati recursion) keeps its previous prediction,
    has its ADMM warm-start state reset, and is flagged infeasible — the
    OCD loop and the outer experiment then apply the reference's
    degraded-solution semantics (continue while ANY agent is usable,
    NL_EU_N_main.py:113-115) instead of poisoning the whole fleet state.

    Works for both the single-fleet path (leading axis = agent) and the
    sharded path (leading axes = scenario, agent).
    """
    ok = (jnp.all(jnp.isfinite(sol.x_pred), axis=(-1, -2))
          & jnp.all(jnp.isfinite(sol.u_pred), axis=(-1, -2)))

    def keep(new, old):
        shape = ok.shape + (1,) * (new.ndim - ok.ndim)
        return jnp.where(ok.reshape(shape), new, old)

    return (keep(sol.x_pred, st.x_pred), keep(sol.u_pred, st.u_pred),
            keep(sol.w, jnp.zeros_like(sol.w)),
            keep(sol.y, jnp.zeros_like(sol.y)),
            keep(sol.rho_scale, jnp.ones_like(sol.rho_scale)),
            sol.feasible & ok, ok)


def _build_ocd_core(track: Track, cfg: ExperimentConfig):
    """Shared OCD machinery: one coordination iteration, the loop carry
    initialiser, the loop condition, and the control-step finaliser.

    ``make_nl_ocd_step`` composes these under one ``lax.while_loop`` (one
    device dispatch per control step — the fast path);
    ``make_nl_ocd_instrumented`` jits the pieces separately so a host loop
    can time and inspect every coordination iteration (the reference's
    ``verb_OCD`` console tier and per-iteration ``time_OCD.dat`` rows,
    ``IOmodule.updateOCD`` / ``base_class.py`` time_OCD).
    """
    from colaborativempc_tpu.runtime.simulate import _per_agent_limits
    if cfg.ocd.sweep not in ("jacobi", "gauss_seidel"):
        raise ValueError(
            f"OCDConfig.sweep must be 'jacobi' or 'gauss_seidel', got "
            f"{cfg.ocd.sweep!r}")
    n_ag = cfg.n_agents
    N = cfg.N
    limits_pa = _per_agent_limits(cfg)
    ns = jnp.asarray(_neighbour_index(n_ag))                    # (n_ag, n_nb)
    ids = jnp.arange(n_ag)
    # master_mask[i, j] = 1 where i < ns[i, j] (price in ego's cost;
    # reference NL_Planner_Eu.py:45-50)
    master_mask = ((ids[:, None] < ns).astype(jnp.float32)
                   if n_ag > 1 else jnp.ones((1, 1), jnp.float32))
    ocd = cfg.ocd

    def one_agent(gains, lane, limits, x0, x_bar, u_bar, u_old, lam_i,
                  neigh_xy, mmask, w, y, rs, pl):
        return nl_solve(
            track, gains, limits, cfg.model, N, cfg.dt,
            x0, x_bar, u_bar, u_old, lam_i, neigh_xy, mmask,
            w0=w, y0=y, rho_scale0=rs,
            sqp_iters=cfg.solver.sqp_iters, sqp_mix=cfg.solver.line_search,
            u_trust=(cfg.solver.u_trust_delta, cfg.solver.u_trust_acc),
            coupling=cfg.coupling, lane=lane,
            admm_iters=cfg.solver.admm_budget(), rho=cfg.solver.rho,
            alpha_relax=cfg.solver.alpha_relax, eps=cfg.solver.eps,
            planes0=pl,
            epoch_len=cfg.solver.epoch_len, unroll=cfg.solver.unroll,
            assoc=cfg.solver.assoc)

    def prepare(state: OCDFleetState) -> OCDFleetState:
        """Per-control-step dynamic lane switch (reference set_lane/
        checkLane) — prev_lane threaded for exact cross-lane lap
        bookkeeping — then the recovery escalation ladder
        (simulate.escalate_holds) before the coordination loop."""
        from colaborativempc_tpu.runtime.simulate import escalate_holds
        if cfg.dynamic_lane:
            lanes, x0_new = jax.vmap(
                lambda x, pl: select_lane(track, x, prev_lane=pl))(
                state.x0, state.lane)
            x_pred = jax.vmap(lambda xs, ln, pl: jax.vmap(
                lambda x: relocalize(track, x, ln, old_lane=pl))(xs))(
                state.x_pred, lanes, state.lane)
            x_pred = x_pred.at[:, 0].set(x0_new)
            state = state._replace(x0=x0_new, x_pred=x_pred, lane=lanes)
        else:
            lanes = jnp.full((n_ag,), cfg.lane, jnp.int32)
        return escalate_holds(track, cfg, state, lanes)

    def agent_lanes(x0):
        if cfg.dynamic_lane:
            return jax.vmap(
                lambda x: check_lane(track, x[7], x[8], x[5])[4])(x0)
        return jnp.full((n_ag,), cfg.lane, jnp.int32)

    def _placeholder_planes(x_pred):
        # single-agent: bisector to the far-away placeholder neighbour so
        # the (inactive) plane row is maximally slack
        pp = x_pred[:, 1:, 7:9]                          # (1, N, 2)
        far = jnp.full_like(pp, 1e6)
        d = far - pp
        dn = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-9)
        a = d / dn[..., None]
        th = jnp.arctan2(a[..., 1], a[..., 0])
        b = -jnp.sum(a * 0.5 * (pp + far), axis=-1)
        return jnp.stack([th, b], axis=-1)[:, None]      # (1, 1, N, 2)

    def ocd_iteration(st: _OCDLoopState, x0, u_old,
                      gains=None) -> _OCDLoopState:
        if gains is None:
            gains = cfg.gains if cfg.gains is not None else nl_gains()
        agents_xy = jnp.swapaxes(st.x_pred[:, :, 7:9], 0, 1)  # (N+1, n_ag, 2)
        if n_ag == 1:
            # placeholder far-away neighbour with a zero price: keeps the
            # constraint-row count consistent with init_nl_fleet (the LPV
            # path's disabled-plane-row analogue)
            neigh = jnp.full((1, N + 1, 1, 2), 1e6, st.x_pred.dtype)
            lam = jnp.zeros((1, 1, N), st.x_pred.dtype)
            pl_i = _placeholder_planes(st.x_pred)
        else:
            neigh = jnp.swapaxes(agents_xy[:, ns, :], 0, 1)   # (n_ag,N+1,nb,2)
            lam = st.lambdas[ids[:, None], ns, :]             # (n_ag, nb, N)
            # canonical pair plane (min, max) regardless of role
            pl_i = st.planes[jnp.minimum(ids[:, None], ns),
                             jnp.maximum(ids[:, None], ns)]   # (n_ag,nb,N,2)

        lanes = agent_lanes(x0)
        if ocd.sweep == "gauss_seidel" and n_ag > 1:
            # Gauss-Seidel sweep: agents solve in id order, each against the
            # FRESHEST neighbour plans (rows already updated this iteration)
            # — the deterministic counterpart of the reference ROS mode's
            # solve-as-soon-as-neighbours-updated asynchrony
            # (OCD_ROS_main.py:178-241). Non-finite solves are contained
            # BEFORE the write so later agents never read a poisoned row.
            def gs_body(x_all, i):
                nb_ids = ns[i]
                nb_xy = jnp.swapaxes(x_all[nb_ids][:, :, 7:9], 0, 1)
                mmask = (i < nb_ids).astype(x_all.dtype)
                lam_i = st.lambdas[i, nb_ids, :]
                pl_it = st.planes[jnp.minimum(i, nb_ids),
                                  jnp.maximum(i, nb_ids)]
                sol_i = one_agent(
                    gains, lanes[i],
                    jax.tree.map(lambda v: v[i], limits_pa),
                    x0[i], x_all[i], st.u_pred[i], u_old[i], lam_i,
                    nb_xy, mmask, st.w[i], st.y[i], st.rho_scale[i], pl_it)
                ok_i = (jnp.all(jnp.isfinite(sol_i.x_pred))
                        & jnp.all(jnp.isfinite(sol_i.u_pred)))
                x_all = x_all.at[i].set(
                    jnp.where(ok_i, sol_i.x_pred, x_all[i]))
                return x_all, sol_i

            _, sol = jax.lax.scan(gs_body, st.x_pred, ids)
        else:
            sol: NLSolution = jax.vmap(
                lambda *a: one_agent(gains, *a))(
                lanes, limits_pa, x0, st.x_pred, st.u_pred, u_old, lam,
                neigh, master_mask, st.w, st.y, st.rho_scale, pl_i)
        x_new, u_new, w_new, y_new, rs_new, feas, ok = _contain_nonfinite(
            st, sol)
        pl_new = jnp.where(ok[:, None, None, None], sol.planes, pl_i)
        if n_ag > 1:
            # masters write their refined planes back to the canonical
            # slots; slave writes land in unread (i > j) slots
            planes = st.planes.at[ids[:, None], ns].set(pl_new)
        else:
            planes = st.planes

        dth = jnp.max(jnp.asarray(cfg.limits.min_dist))
        p = x_new[:, 1:, 7:9]                                 # (n_ag, N, 2)
        if cfg.coupling == "hp_opt":
            # eval_constraintHp on the refined plane and the SLAVE's new
            # position (NL_HP_N_main.py:127-133, NL/config.py:25-29):
            # g = dth/2 - (a.p_slave + b)
            th = planes[..., 0]
            bpl = planes[..., 1]
            val = (jnp.cos(th) * p[None, :, :, 0]
                   + jnp.sin(th) * p[None, :, :, 1] + bpl)    # (i, j, N)
            g = dth / 2.0 - val
        else:
            # dual ascent on master pairs i < j (NL_EU_N_main.py:130-139):
            # "eu": lambda += alpha * (dth - ||p_i - p_j||)
            # "hp": lambda += alpha * (dth - dist)/2 - the reference's
            #       eval_constraintHp on the geometric bisector
            diff = p[:, None, :, :] - p[None, :, :, :]        # (i, j, N, 2)
            dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-9)
            g = dth - dist                                    # (i, j, N)
            if cfg.coupling == "hp":
                g = 0.5 * g
        upper = (ids[:, None] < ids[None, :]).astype(g.dtype)[:, :, None]
        g = g * upper
        lambdas, alpha = _dual_step(ocd, st, g)

        # convergence test (NL_EU_N_main.py:141-157)
        conv = jnp.all(jnp.abs(st.x_pred - x_new) < ocd.atol)
        conv_count = jnp.where(conv, st.conv_count + 1, 0)
        finished = (conv_count > ocd.it_conv) | (st.it_ocd >= ocd.max_it_ocd)

        new_st = _OCDLoopState(
            x_pred=x_new, u_pred=u_new, x_old=st.x_pred,
            lambdas=lambdas, alpha=alpha, g_prev=g, planes=planes,
            w=w_new, y=y_new, rho_scale=rs_new,
            it_ocd=st.it_ocd + 1, conv_count=conv_count,
            finished=finished, feasible=feas)
        # Per-fleet freeze: once THIS fleet's stop predicate holds (the
        # single-fleet while_loop exit condition), the iteration becomes the
        # identity. In the single-fleet while_loop the body is never entered
        # with stop=True, so this is free; under vmap (battery / Monte-Carlo
        # lanes) the loop body keeps running until EVERY lane's condition is
        # false, and without the freeze converged lanes' duals/plans would
        # keep updating past their own convergence point — deviating from
        # the reference's per-run convergence (NL_EU_N_main.py:141-162) and
        # corrupting per-lane OCD-iteration statistics.
        stop = (st.it_ocd > ocd.min_it_ocd) & st.finished
        return jax.tree.map(lambda old, new: jnp.where(stop, old, new),
                            st, new_st)

    def loop_init(state: OCDFleetState) -> _OCDLoopState:
        return _OCDLoopState(
            x_pred=state.x_pred, u_pred=state.u_pred, x_old=state.x_pred,
            lambdas=state.lambdas,
            alpha=jnp.full_like(state.lambdas, ocd.alpha),
            g_prev=jnp.zeros_like(state.lambdas),
            planes=_bisector_planes(state.x_pred),
            w=state.w, y=state.y,
            rho_scale=state.rho_scale,
            it_ocd=jnp.asarray(0), conv_count=jnp.asarray(0),
            finished=jnp.asarray(False),
            feasible=jnp.ones((n_ag,), bool))

    def cond(st):
        # force min_it_ocd, run until finished (NL_EU_N_main.py:105)
        return ~((st.it_ocd > ocd.min_it_ocd) & st.finished)

    def finalize(out: _OCDLoopState, state: OCDFleetState):
        # Solver-failure containment on the EXECUTED plan, the NL twin of
        # the LPV step's hold_on_infeasible (runtime/simulate.py): an agent
        # whose final sub-problem solve ended above the feasibility
        # tolerance does NOT execute that plan — it follows its previous
        # plan one more stage and retries next step from that saner
        # linearisation. Coupling duals KEEP their updated values (the
        # coordination knowledge is sound; it is the primal solve that
        # failed); the agent's ADMM warm state keeps its pre-failure
        # values. Without this the closed loop executes unconverged plans
        # (reference degraded-solve semantics, NL_EU_N_main.py:113-115),
        # which the full-course study showed compounds to fleet deadlock/
        # divergence at long horizons. Identity on feasible
        # steps (equality-tested).
        jam_count = jnp.where(out.feasible, 0, state.jam_count + 1)
        if cfg.hold_on_infeasible:
            # degraded-execution escape after hold_exec_k consecutive
            # infeasible solves (runtime/simulate.py rationale)
            ok = out.feasible
            degraded = jnp.zeros_like(ok)
            if cfg.hold_exec_k is not None:
                finite = (jnp.all(jnp.isfinite(out.x_pred), axis=(1, 2))
                          & jnp.all(jnp.isfinite(out.u_pred), axis=(1, 2)))
                degraded = ((~ok) & finite
                            & (state.jam_count >= cfg.hold_exec_k))
                ok = ok | degraded
            ok3 = ok[:, None, None]
            hold_x = jnp.concatenate(
                [state.x_pred[:, 1:], state.x_pred[:, -1:]], axis=1)
            hold_u = jnp.concatenate(
                [state.u_pred[:, 1:], state.u_pred[:, -1:]], axis=1)
            x_fin = jnp.where(ok3, out.x_pred, hold_x)
            u_fin = jnp.where(ok3, out.u_pred, hold_u)
            w_fin = jnp.where(ok3, out.w, state.w)
            y_fin = jnp.where(ok3, out.y, state.y)
            rs_fin = jnp.where(ok[:, None], out.rho_scale, state.rho_scale)
            hold_count = jnp.where(out.feasible, 0, state.hold_count + 1)
        else:
            x_fin, u_fin = out.x_pred, out.u_pred
            w_fin, y_fin, rs_fin = out.w, out.y, out.rho_scale
            hold_count = state.hold_count

        # physical execution envelope (kinematic bounds + track-limits
        # wall), then the executed-separation safety filter
        # (runtime/simulate.py): the applied x0-shift is projected so no
        # pair crosses the hard floor and no agent leaves the envelope;
        # the shifted plan stays the linearisation
        from colaborativempc_tpu.runtime.simulate import (
            lateral_wall, separation_filter)
        x0_cand, wall_clip = lateral_wall(track, cfg, state.x0,
                                          x_fin[:, 1, :], state.lane)
        x0_exec, exec_beta = separation_filter(cfg, state.x0, x0_cand)
        brake_count = jnp.where(exec_beta < 1.0, state.brake_count + 1,
                                jnp.zeros_like(state.brake_count))

        # control-step shift (NL_EU_N_main.py:170-172): x0 <- x_pred[1],
        # linearisation trajectory <- shifted prediction
        x_shift = jnp.concatenate([x_fin[:, 1:], x_fin[:, -1:]], axis=1)
        u_shift = jnp.concatenate([u_fin[:, 1:], u_fin[:, -1:]], axis=1)
        new_state = OCDFleetState(
            x0=x0_exec,
            x_pred=x_shift, u_pred=u_shift,
            u_old=u_fin[:, 0, :],
            lambdas=out.lambdas, w=w_fin, y=y_fin,
            rho_scale=rs_fin,
            lane=state.lane, hold_count=hold_count,
            brake_count=brake_count, jam_count=jam_count)

        p = x_fin[:, 1:, 7:9]
        diff = p[:, None] - p[None, :]
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-12)
        dist = dist + jnp.eye(n_ag)[:, :, None] * 1e9
        pe = x0_exec[:, 7:9]
        de = jnp.sqrt(jnp.sum((pe[:, None] - pe[None, :]) ** 2, axis=-1)
                      + 1e-12) + jnp.eye(n_ag) * 1e9
        metrics = OCDStepMetrics(
            ocd_iterations=out.it_ocd,
            feasible=out.feasible,
            min_dist=jnp.min(dist),
            min_dist_exec=jnp.min(de),
            lambda_max=jnp.max(jnp.abs(out.lambdas)),
            exec_beta=exec_beta, wall_clip=wall_clip)
        return new_state, metrics

    return prepare, ocd_iteration, loop_init, cond, finalize


def make_nl_ocd_step(track: Track, cfg: ExperimentConfig):
    """Build the jitted one-control-step function: a full OCD inner loop."""
    prepare, ocd_iteration, loop_init, cond, finalize = _build_ocd_core(
        track, cfg)

    def step(state: OCDFleetState):
        state = prepare(state)
        out = jax.lax.while_loop(
            cond, lambda st: ocd_iteration(st, state.x0, state.u_old),
            loop_init(state))
        return finalize(out, state)

    return jax.jit(step)


def make_nl_ocd_rollout(track: Track, cfg: ExperimentConfig, steps: int):
    """Fixed-step fully-on-device NL-OCD rollout: ``lax.scan`` over control
    steps, each step a complete coordination ``while_loop`` — the NL twin
    of ``simulate.make_lpv_fleet_rollout`` (no host dispatch between steps;
    for benchmarks/sweeps — ``run_nl_experiment`` keeps the host loop for
    termination + IO). Returns jitted
    ``state -> (final_state, (x0_hist, u_hist, OCDStepMetrics))``.
    """
    prepare, ocd_iteration, loop_init, cond, finalize = _build_ocd_core(
        track, cfg)

    def one_step(state: OCDFleetState):
        state = prepare(state)
        out = jax.lax.while_loop(
            cond, lambda st: ocd_iteration(st, state.x0, state.u_old),
            loop_init(state))
        return finalize(out, state)

    def rollout(state: OCDFleetState):
        def body(st, _):
            st2, m = one_step(st)
            return st2, (st2.x0, st2.u_old, m)
        return jax.lax.scan(body, state, None, length=steps)

    return jax.jit(rollout)


def make_nl_ocd_rollout_gains(track: Track, cfg: ExperimentConfig,
                              steps: int):
    """Like :func:`make_nl_ocd_rollout` but with the gain pytree as a
    TRACED argument, so a ``vmap`` over a gain grid advances the whole
    battery as ONE device program (the reference's experiment battery
    sweeps {N, Qvx, Qey, Qew, QdU, QU} through the NL-OCD pipeline,
    ``planner/scripts/experiment_battery.py:15-38``, serially re-invoking
    the full experiment per combination). Returns jitted
    ``(gains, state) -> (final_state, (x0_hist, u_hist, OCDStepMetrics))``.
    """
    prepare, ocd_iteration, loop_init, cond, finalize = _build_ocd_core(
        track, cfg)

    def one_step(gains, state: OCDFleetState):
        state = prepare(state)
        out = jax.lax.while_loop(
            cond,
            lambda st: ocd_iteration(st, state.x0, state.u_old, gains),
            loop_init(state))
        return finalize(out, state)

    def rollout(gains, state: OCDFleetState):
        def body(st, _):
            st2, m = one_step(gains, st)
            return st2, (st2.x0, st2.u_old, m)
        return jax.lax.scan(body, state, None, length=steps)

    return jax.jit(rollout)


def make_nl_ocd_instrumented(track: Track, cfg: ExperimentConfig):
    """Host-driven OCD control step with true per-iteration device timing.

    The fast path (``make_nl_ocd_step``) runs the whole coordination loop
    as ONE device dispatch, so per-iteration wall times do not exist on the
    host. This variant jits one coordination ITERATION and loops on the
    host — slower per step (one dispatch per iteration) but it yields what
    the reference's verbose tier reports (``verb_OCD`` prints +
    ``IOmodule.updateOCD``) and real per-iteration rows for time_OCD.dat
    (``base_class.py:64-99``).

    Returns ``step(state, on_iteration=None) -> (new_state, metrics,
    iter_times)`` where ``on_iteration(it_ocd, seconds, delta)`` is called
    after every coordination iteration with its device wall time and the
    max trajectory change.
    """
    prepare, ocd_iteration, loop_init, cond, finalize = _build_ocd_core(
        track, cfg)
    prep_jit = jax.jit(prepare)
    it_jit = jax.jit(ocd_iteration)
    init_jit = jax.jit(loop_init)
    fin_jit = jax.jit(finalize)

    ocd = cfg.ocd

    def step(state: OCDFleetState, on_iteration=None):
        state = prep_jit(state)
        st = jax.block_until_ready(init_jit(state))
        iter_times = []
        # the loop condition is evaluated on the HOST: two scalar fetches
        # per iteration instead of eager per-op dispatch
        while not (int(st.it_ocd) > ocd.min_it_ocd and bool(st.finished)):
            t0 = time.time()
            st = jax.block_until_ready(it_jit(st, state.x0, state.u_old))
            dt_it = time.time() - t0
            iter_times.append(dt_it)
            if on_iteration is not None:
                delta = float(np.abs(np.asarray(st.x_pred)
                                     - np.asarray(st.x_old)).max())
                on_iteration(int(st.it_ocd), dt_it, delta)
        new_state, metrics = fin_jit(st, state)
        return new_state, metrics, iter_times

    return step


def init_nl_fleet(track: Track, cfg: ExperimentConfig,
                  x0s: Optional[np.ndarray] = None,
                  lambdas0: Optional[np.ndarray] = None) -> OCDFleetState:
    """Initial fleet state; ``lambdas0`` warm-starts the duals (the
    reference's ini_lambdas pickle, misc.py:218-231)."""
    dtype = jnp.float32 if cfg.dtype == "float32" else jnp.float64
    if x0s is None:
        x0s = x0_database(cfg.n_agents)
    x0s = jnp.asarray(x0s, dtype)
    _, x_pred, u_pred = initialise_agents(track, x0s, cfg.N, cfg.dt,
                                          lane=cfg.lane)
    n_nb = max(cfg.n_agents - 1, 1)
    m = 4 + (3 * n_nb if cfg.coupling == "hp_opt" else n_nb)
    if lambdas0 is None:
        lambdas0 = jnp.zeros((cfg.n_agents, cfg.n_agents, cfg.N), dtype)
    else:
        lambdas0 = jnp.asarray(lambdas0, dtype)
    return OCDFleetState(
        x0=x_pred[:, 0, :], x_pred=x_pred, u_pred=u_pred,
        u_old=jnp.zeros((cfg.n_agents, 2), dtype),
        lambdas=lambdas0,
        w=jnp.zeros((cfg.n_agents, cfg.N, m), dtype),
        y=jnp.zeros((cfg.n_agents, cfg.N, m), dtype),
        rho_scale=jnp.ones((cfg.n_agents, m), dtype),
        lane=jnp.full((cfg.n_agents,), cfg.lane, jnp.int32),
        hold_count=jnp.zeros((cfg.n_agents,), jnp.int32),
        brake_count=jnp.zeros((cfg.n_agents,), jnp.int32),
        jam_count=jnp.zeros((cfg.n_agents,), jnp.int32))


class NLExperimentResult(NamedTuple):
    states: np.ndarray
    inputs: np.ndarray
    feasible: np.ndarray
    min_dist: np.ndarray
    min_dist_exec: np.ndarray
    ocd_iterations: np.ndarray
    step_times: np.ndarray
    lambdas: np.ndarray     # final duals (cross-run warm start)
    steps: int
    finished: bool
    exec_beta: np.ndarray = np.ones((0, 0))  # (T, n_ag) separation-filter
    #                          advance fractions (1.0 = filter inactive)
    wall_clip: np.ndarray = np.zeros((0, 0), bool)  # (T, n_ag) lateral
    #                          wall clamps


def run_nl_experiment(cfg: ExperimentConfig,
                      x0s: Optional[np.ndarray] = None,
                      lambdas0: Optional[np.ndarray] = None,
                      track: Optional[Track] = None,
                      io=None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 50) -> NLExperimentResult:
    """Closed-loop distributed NL-OCD experiment (reference
    ``NL_EU_N_main.main``).

    ``checkpoint_path`` enables exact mid-run resume, identical to the
    LPV path (runtime/checkpoint.py): the FULL ``OCDFleetState`` —
    including the coupling duals ``lambdas``, which the reference only
    persists ACROSS runs via ``ini_lambdas.pkl``
    (``NL_EU_N_main.py:174-175``) — round-trips through one .npz, so a
    916-step golden replay can be stopped and resumed mid-course with
    bit-equal coordination state.
    """
    import os
    from colaborativempc_tpu.runtime.checkpoint import (
        save_checkpoint, load_checkpoint,
    )
    from colaborativempc_tpu.utils.precision import dtype_island
    if cfg.dtype == "float64" and not jax.config.jax_enable_x64:
        # float64 experiments run as a scoped x64 island (utils/precision.py)
        with dtype_island(cfg.dtype):
            return run_nl_experiment(cfg, x0s, lambdas0, track, io,
                                     checkpoint_path, checkpoint_every)
    # Full single-fleet latency schedule, shared with run_lpv_experiment
    # (runtime/simulate.py resolve_single_fleet_schedule): epoch_len=15
    # (frequent rho adaptation), blocked-assoc Riccati, admm_iters>=1000 —
    # measured on NL N=125 in the round-4 study; batched/sharded paths keep
    # the throughput defaults. Pin any SolverConfig knob to override.
    from colaborativempc_tpu.runtime.simulate import (
        resolve_single_fleet_schedule)
    cfg = resolve_single_fleet_schedule(cfg)
    if track is None:
        track = make_track(cfg.map_type,
                           dtype=jnp.float64 if cfg.dtype == "float64"
                           else jnp.float32)
    state = init_nl_fleet(track, cfg, x0s, lambdas0)
    it = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, it = load_checkpoint(checkpoint_path, state)
    if cfg.verb_ocd:
        step_inst = make_nl_ocd_instrumented(track, cfg)
    else:
        step = make_nl_ocd_step(track, cfg)

    hist = {k: [] for k in ("states", "inputs", "feas", "dist", "dist_e",
                            "ocd_it", "times", "beta", "wall")}
    finished = False
    while it < cfg.max_it:
        t0 = time.time()
        if cfg.verb_ocd:
            def on_it(it_ocd, secs, delta, _step=it):
                if cfg.verb >= 2:
                    print(f"  [step {_step} OCD {it_ocd}] "
                          f"{secs * 1e3:.1f}ms dx_max={delta:.4f}")
            state, metrics, iter_times = step_inst(state, on_it)
            if io is not None and hasattr(io, "ocd_iter_times"):
                io.ocd_iter_times.append(iter_times)
        else:
            state, metrics = step(state)
        state = jax.block_until_ready(state)
        hist["times"].append(time.time() - t0)
        hist["states"].append(np.asarray(state.x0))
        hist["inputs"].append(np.asarray(state.u_old))
        hist["feas"].append(np.asarray(metrics.feasible))
        hist["dist"].append(float(metrics.min_dist))
        hist["dist_e"].append(float(metrics.min_dist_exec))
        hist["ocd_it"].append(int(metrics.ocd_iterations))
        hist["beta"].append(np.asarray(metrics.exec_beta))
        hist["wall"].append(np.asarray(metrics.wall_clip))
        if io is not None:
            io.update(it, state, metrics, hist["times"][-1])
        # reference NL semantics: continue on degraded/partial solves,
        # abort only when NO agent produced a usable solution
        # (NL_EU_N_main.py:113-115 'if not np.any(feas)')
        if not bool(np.any(hist["feas"][-1])):
            break
        if bool(np.any(np.asarray(
                check_end(track, state.x0[:, 6], laps=cfg.laps,
                          lane=cfg.lane)))):
            finished = True
            break
        it += 1
        if checkpoint_path is not None and it % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state, it)

    if checkpoint_path is not None:
        save_checkpoint(checkpoint_path, state, it)
    return NLExperimentResult(
        states=np.asarray(hist["states"]), inputs=np.asarray(hist["inputs"]),
        feasible=np.asarray(hist["feas"]), min_dist=np.asarray(hist["dist"]),
        min_dist_exec=np.asarray(hist["dist_e"]),
        ocd_iterations=np.asarray(hist["ocd_it"]),
        step_times=np.asarray(hist["times"]),
        lambdas=np.asarray(state.lambdas),
        steps=len(hist["states"]), finished=finished,
        exec_beta=np.asarray(hist["beta"]),
        wall_clip=np.asarray(hist["wall"]))
