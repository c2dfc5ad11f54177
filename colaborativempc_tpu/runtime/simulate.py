"""Closed-loop multi-agent experiment runtimes.

The in-process scheduler of the reference (``planner/scripts/LPV_HP_N_main.py``
:57-122, ``NL_EU_N_main.py:42-185``) re-designed for the accelerator: the
per-control-step work of ALL agents is one jitted function — agents are a
vmapped batch axis (or a shard_map mesh axis, see parallel/), the trajectory
exchange that ROS pub/sub performed (``OCD_ROS_main.py:89-91``) is a tensor transpose (one
all_gather when sharded), and the host only runs the outer control loop and
IO. The planning convention matches the reference: the MPC prediction IS the
plant (x0 <- xPred[1], ``LPV_HP_N_main.py:106``).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from colaborativempc_tpu.config.params import (
    ExperimentConfig, lpv_gains)
from colaborativempc_tpu.geometry import Track, make_track, check_end
from colaborativempc_tpu.planners.lpv import lpv_solve, LPVSolution
from colaborativempc_tpu.utils.warmstart import initialise_agents
from colaborativempc_tpu.config.params import x0_database


class FleetState(NamedTuple):
    """Per-agent planning state carried across control steps."""
    x0: jnp.ndarray       # (n_ag, 9) current states
    x_pred: jnp.ndarray   # (n_ag, N+1, 9) last predictions (linearisation)
    u_pred: jnp.ndarray   # (n_ag, N, 2)
    u_old: jnp.ndarray    # (n_ag, 2) last applied inputs
    w: jnp.ndarray        # (n_ag, N, m) ADMM splitting warm start
    y: jnp.ndarray        # (n_ag, N, m)
    rho_scale: jnp.ndarray  # (n_ag, m) per-row-class adaptive-rho warm start
    lane: jnp.ndarray     # (n_ag,) int32 lane each x0's Frenet row lives on
    hold_count: jnp.ndarray  # (n_ag,) int32 consecutive plan-holds (ladder)
    brake_count: jnp.ndarray  # (n_ag,) int32 consecutive separation-
    #   filter brakings (feeds the same vx_ref ramp as holds: a braked
    #   solve is FEASIBLE, so hold_count never sees it — without this
    #   counter a filter-braked cluster is a fixed point the planner can
    #   park in, replanning the same closing step forever; round-5 study)
    jam_count: jnp.ndarray    # (n_ag,) int32 consecutive infeasible
    #   solves, NEVER reset by the escalation ladder (hold_count cycles
    #   0..hold_cold_k because the cold rung zeroes it) — drives the
    #   degraded-execution escape (cfg.hold_exec_k)


class StepMetrics(NamedTuple):
    feasible: jnp.ndarray     # (n_ag,)
    iterations: jnp.ndarray   # (n_ag,)
    r_prim: jnp.ndarray       # (n_ag,)
    min_dist: jnp.ndarray     # scalar: min pairwise distance over horizon
    min_dist_exec: jnp.ndarray  # scalar: min pairwise distance of x0 states
    slack_max: jnp.ndarray    # (n_ag,) max slack magnitude
    exec_beta: jnp.ndarray    # (n_ag,) separation-filter advance fraction
    #                           (1.0 = filter inactive, plan executed as-is)
    wall_clip: jnp.ndarray    # (n_ag,) track-limits wall clamped this
    #                           agent's executed lateral offset


def _neighbour_index(n_agents: int) -> np.ndarray:
    """ns[i] = all agent ids except i (reference main scripts' ``ns``)."""
    return np.array([[j for j in range(n_agents) if j != i]
                     for i in range(n_agents)], dtype=np.int32)


def _pairwise_min_dist(agents_xy: jnp.ndarray) -> jnp.ndarray:
    """Min distance between any agent pair over horizon stages 1..N."""
    p = agents_xy[1:]                                 # (N, n_ag, 2)
    d = p[:, :, None, :] - p[:, None, :, :]
    dist = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-12)
    n = p.shape[1]
    dist = dist + jnp.eye(n)[None] * 1e9
    return jnp.min(dist)


def _per_agent_limits(cfg: ExperimentConfig):
    """Limits as a vmappable pytree with an (n_agents,) leading axis.

    Heterogeneous fleets (e.g. a slow leader being overtaken) set any
    SysLimits field to an (n_agents,) array; scalars broadcast. The
    reference shares one sys_lim across the fleet (base_class.py:30-41) —
    this generalises it with zero cost for the homogeneous case.
    """
    return jax.tree.map(
        lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32),
                                   (cfg.n_agents,)),
        cfg.limits)


def _sep_filter_beta(p0: jnp.ndarray, p1: jnp.ndarray, floor,
                     prio: jnp.ndarray | None = None,
                     n_pass: int = 4) -> jnp.ndarray:
    """Per-agent advance fractions bounding the executed pairwise distance.

    Each agent's executed position is p(beta) = p0 + beta * (p1 - p0):
    beta = 1 executes the plan's first stage as-is, beta = 0 re-executes
    the current position (standstill). This computes large per-agent
    betas such that **no pair's executed distance falls below
    g = min(floor, its standstill distance)** — the monotone
    non-worsening guarantee: a pair at/above the floor is braked exactly
    to it, a pair already below it never gets closer than standing
    still, so a fleet that starts above the floor can never be driven
    below it.

    Braking is PRIORITY-ASYMMETRIC (round-5: the first filter cut both
    agents of a closing pair by a common factor, and a symmetric full
    stop is a fixed point — two laterally-converging agents re-plan the
    same closing step forever and the fleet parks; measured on 2 of 8
    stressed starts, round-5 study). Per pair the agent with the
    LOWER priority (arc progress s, ties by index) is the follower:

    - if the candidate pair distance ends >= g: nobody brakes;
    - else if a STOPPED follower satisfies g against the leader's moved
      position: only the follower brakes — the largest t with
      |a' + t b'| >= g along its own segment (a' = follower standstill
      rel. to the moved leader, b' = the follower's motion; d^2 convex
      in t with d^2(0) >= g^2, so everything left of the smaller root
      of |b'|^2 t^2 + 2(a'.b') t + (|a'|^2 - g^2) keeps d >= g). The
      leader drives on and opens the gap — the deadlock-breaker;
    - else (the leader's own motion violates g even against a stopped
      follower): both scale by the symmetric common factor t along
      a + t*b (a = standstill offsets, b = relative motion; same
      convex-root form with c = d0^2 - g^2 >= 0 by construction — a
      closing pair at its standstill distance gets t = 0 exactly).

    Each agent takes the most conservative t over its pairs; passes
    iterate because per-agent betas couple the pairs (a follower braked
    for one pair weakens the leader assumption of another). A final
    all-stop fallback (every beta = 0 — exactly the standstill
    distances) backstops the guarantee against residual coupling.

    Exactness: when no pair would cross the floor, every t is exactly
    1.0 and the returned betas are exactly 1.0 (callers use that to keep
    the unfiltered states bit-identical).
    """
    n = p0.shape[0]
    delta = p1 - p0
    eyeb = jnp.eye(n, dtype=bool)
    a0 = p0[:, None] - p0[None, :]                        # (i, j, 2)
    d0sq = jnp.sum(a0 * a0, axis=-1)
    floor = jnp.asarray(floor, p0.dtype)
    f2 = floor * floor
    g2 = jnp.minimum(f2, d0sq)                            # pair guarantee^2
    if prio is None:
        prio = jnp.zeros_like(p0[..., 0])
    # strict priority: larger s wins, exact index tie-break (lexicographic
    # — a float epsilon would drown in s's magnitude at long courses)
    idx = jnp.arange(n)
    follows = ((prio[:, None] < prio[None, :])
               | ((prio[:, None] == prio[None, :])
                  & (idx[:, None] > idx[None, :])))       # i follows j

    def brake_root(ab, bb, c):
        # largest t in [0, 1] with the convex d^2(t) >= g^2 given
        # d^2(0) - g^2 = c >= 0: the smaller root of
        # bb t^2 + 2 ab t + c (the negative set is an interval).
        # Shaved by 1e-3 so a braked agent stops marginally SHORT of the
        # floor: landing exactly on it makes every later step a float32
        # boundary case (candidate at floor +- eps -> endless refilter).
        disc = ab * ab - bb * c
        root = ((-ab - jnp.sqrt(jnp.maximum(disc, 0.0)))
                / jnp.maximum(bb, 1e-12))
        return jnp.clip(root, 0.0, 1.0) * (1.0 - 1e-3)

    def one_pass(beta, _):
        q = p0 + beta[:, None] * delta                    # moved positions
        # symmetric rule: both members scale by t
        b = (beta[:, None, None] * delta[:, None]
             - beta[None, :, None] * delta[None, :])      # (i, j, 2)
        bb = jnp.sum(b * b, axis=-1)
        ab = jnp.sum(a0 * b, axis=-1)
        d1sq = d0sq + 2.0 * ab + bb                       # pair dist^2 at t=1
        t_sym = brake_root(ab, bb, d0sq - g2)
        # follower-only rule: i moves along its segment, j fixed at q_j
        a_f = p0[:, None] - q[None, :]                    # (i, j, 2)
        af2 = jnp.sum(a_f * a_f, axis=-1)
        b_f = jnp.broadcast_to((beta[:, None] * delta)[:, None],
                               a_f.shape)                 # i's motion
        ab_f = jnp.sum(a_f * b_f, axis=-1)
        bb_f = jnp.sum(b_f * b_f, axis=-1)
        c_f = af2 - g2
        fol_ok = c_f >= 0.0          # a stopped i suffices against moved j
        t_fol = brake_root(ab_f, bb_f, jnp.maximum(c_f, 0.0))

        t_ij = jnp.where(
            d1sq >= g2, jnp.ones_like(d1sq),
            jnp.where(follows,
                      jnp.where(fol_ok, t_fol, t_sym),
                      # i leads j: free when j's follower rule held,
                      # else the symmetric brake binds both
                      jnp.where(jnp.swapaxes(fol_ok, -1, -2),
                                jnp.ones_like(d1sq), t_sym)))
        t_ij = jnp.where(eyeb, 1.0, t_ij)
        return beta * jnp.min(t_ij, axis=1), None

    # carry tied to the data (ones_like, not ones) so the varying mesh
    # axes match inside shard_map contexts
    beta, _ = jax.lax.scan(one_pass, jnp.ones_like(p0[..., 0]), None,
                           length=n_pass)
    # all-stop fallback: per-agent betas are pair-coupled, so verify the
    # result and fall back to exact standstill if any pair is still both
    # below the floor and MATERIALLY closer than it stood. The margin
    # must sit well above float32 rounding of the squared distances
    # (eps(0.03 m^2) ~ 2e-9): a 1e-9 margin measured as a permanent
    # fleet-wide freeze — rounding noise tripped the fallback every
    # step while the true distances were unchanged (round-5 lane-3
    # park). Relative + absolute so it scales with distance.
    p = p0 + beta[:, None] * delta
    dd = p[:, None] - p[None, :]
    dsq = jnp.sum(dd * dd, axis=-1)
    margin = jnp.maximum(1e-4 * d0sq, 1e-7)
    bad = jnp.any((dsq < f2) & (dsq < d0sq - margin) & ~eyeb)
    return jnp.where(bad, jnp.zeros_like(beta), beta)


def _apply_exec_beta(x_cur: jnp.ndarray, x_cand: jnp.ndarray,
                     beta: jnp.ndarray) -> jnp.ndarray:
    """Braking along the plan: interpolate the FULL state row between the
    current state (beta=0) and the plan's first stage (beta=1), then
    scale the velocity fields (vx, vy, wz) by beta so the executed state
    is a truthful BRAKE: the position advanced beta of a stage, so the
    realized speed is ~beta times the planned one. Without the scaling a
    hard-braked agent kept its cruising vx while standing still, and the
    next linearisation planned from that phantom momentum — measured to
    end in a spin-and-reverse divergence after the jam cleared (round-5
    lane-3 study; the vx<0.2 straight-line switch in the LPV
    embedding keeps near-zero speeds well-posed, dynamics/bicycle.py).
    Bit-identical to the candidate wherever beta == 1."""
    lerp = x_cur + beta[..., None] * (x_cand - x_cur)
    vel_scaled = lerp.at[..., 0:3].multiply(beta[..., None])
    return jnp.where((beta >= 1.0)[..., None], x_cand, vel_scaled)


def separation_filter(cfg: ExperimentConfig, x_cur: jnp.ndarray,
                      x_cand: jnp.ndarray):
    """Executed-separation safety filter (``cfg.exec_sep_frac``).

    ``x_cur`` (n_ag, 9): current states (the standstill anchor);
    ``x_cand`` (n_ag, 9): candidate executed states (the plan's stage 1,
    post plan-holding). Returns ``(x_exec, beta)`` with the floor
    guarantee of :func:`_sep_filter_beta` on the executed (X, Y) rows.
    Neither the reference nor rounds 1-4 bounded executed separation at
    all (the soft plane rows saturate in deep congestion; the
    reference's own recordings violate dth, PARITY.md) — this closes
    that hole. Identity (bit-exact) when no pair would cross the floor.
    """
    if cfg.exec_sep_frac is None:
        return x_cand, jnp.ones(x_cand.shape[:-1], x_cand.dtype)
    dth = jnp.max(jnp.asarray(cfg.limits.min_dist))
    floor = jnp.asarray(cfg.exec_sep_frac, x_cand.dtype) * dth
    beta = _sep_filter_beta(x_cur[:, 7:9], x_cand[:, 7:9], floor,
                            prio=x_cur[:, 6])
    return _apply_exec_beta(x_cur, x_cand, beta), beta


def lateral_wall(track: Track, cfg: ExperimentConfig, x_cur: jnp.ndarray,
                 x_cand: jnp.ndarray, lanes: jnp.ndarray):
    """Physical execution envelope on the executed stage
    (``cfg.exec_ey_wall``): every applied x0-shift must be KINEMATICALLY
    REACHABLE from where the agent actually stands.

    Under the prediction-is-plant convention the plan's first stage IS
    the plant step, so a garbage plan teleports the agent — and a
    garbage LINEARISATION can produce garbage plans that the QP solves
    "feasibly" (converged on a meaningless problem). Both round-5
    canonical-course failure modes came through this door: an executed
    stage beyond the Frenet chart's validity (|ey| > 1/kappa) stranded
    an agent meters off the track, and a feasible-garbage spiral flew
    another to s ~ +9900. The envelope bounds, per agent:

    - arc advance: Delta-s in [-max_vel*dt, 2*max_vel*dt];
    - lateral offset: |ey| <= max(wall * halfwidth(s), current |ey|) —
      the track-limits wall proper (outward past the wall is blocked,
      inward recovery never is; monotone non-worsening like the
      separation filter);
    - velocities: vx in [min_vel, max_vel], |vy| <= max_vel,
      |wz| <= 4*pi;
    - heading error: epsi wrapped into [-pi, pi] (only when outside);
    - (X, Y): REBUILT from the clamped Frenet pose whenever s or ey
      clamped (Frenet is the source of truth).

    Callers apply this BEFORE the separation filter, whose lerp then
    interpolates between the current and enveloped states — the floor,
    the wall and the kinematic bounds all hold on the final executed
    states. Bit-identical whenever the candidate is already inside the
    envelope (every healthy step). Returns ``(x_exec, clamped)``.
    """
    if cfg.exec_ey_wall is None:
        return x_cand, jnp.zeros(x_cand.shape[:-1], bool)
    from colaborativempc_tpu.geometry import (
        frenet_to_cartesian, halfwidth, wrap_to_pi,
    )
    lim = cfg.limits
    max_v = jnp.max(jnp.asarray(lim.max_vel))
    min_v = jnp.min(jnp.asarray(lim.min_vel))

    def one(xc, xe, ln):
        dt = jnp.asarray(cfg.dt, xe.dtype)
        ds = jnp.clip(xe[6] - xc[6], -max_v * dt, 2.0 * max_v * dt)
        s_new = xc[6] + ds
        hw = halfwidth(track, s_new, ln)
        bound = jnp.maximum(
            hw * jnp.asarray(cfg.exec_ey_wall, xe.dtype), jnp.abs(xc[3]))
        ey_new = jnp.clip(xe[3], -bound, bound)
        pose_moved = (ey_new != xe[3]) | (s_new != xe[6])
        px, py, _ = frenet_to_cartesian(track, s_new, ey_new, ln)
        xe2 = xe.at[3].set(ey_new).at[6].set(s_new)
        xe2 = jnp.where(pose_moved,
                        xe2.at[7].set(px).at[8].set(py), xe2)
        vx_c = jnp.clip(xe[0], min_v, max_v)
        vy_c = jnp.clip(xe[1], -max_v, max_v)
        wz_c = jnp.clip(xe[2], -4.0 * jnp.pi, 4.0 * jnp.pi)
        ep_c = jnp.where(jnp.abs(xe[4]) > jnp.pi, wrap_to_pi(xe[4]),
                         xe[4])
        xe2 = (xe2.at[0].set(vx_c).at[1].set(vy_c).at[2].set(wz_c)
               .at[4].set(ep_c))
        clamped = (pose_moved | (vx_c != xe[0]) | (vy_c != xe[1])
                   | (wz_c != xe[2]) | (ep_c != xe[4]))
        return jnp.where(clamped, xe2, xe), clamped

    for _ in range(x_cand.ndim - 2):
        one = jax.vmap(one)
    return jax.vmap(one)(x_cur, x_cand, lanes)


def hold_vx_scale(cfg: ExperimentConfig, count, dtype=jnp.float32):
    """Recovery feasibility pass (``cfg.hold_vx_frac``): per-agent
    vx_ref multipliers — exactly 1.0 below the ``hold_reset_k`` rung,
    ``hold_vx_frac`` at the rung and beyond — so a PERSISTENTLY jammed
    retry competes less with the separation/lane rows while transient
    1-2-step holds retry at full speed.

    Shape rationale (round-5 campaign): the binary rung keeps
    transient holds — which the canonical courses' hard window produces
    and recovers from at full speed — entirely outside the pass, while
    engaging it exactly where the measured win lives (the round-4
    348/550-held parking, where counts sit at the rung for hundreds of
    steps, drops to single digits). A deeper decay to frac^2 beyond
    the rung measured WORSE (8/8 -> 6/8 stressed completion, worst
    start 245 -> 393 held steps): crawling prolongs the fleet's
    exposure to the congestion window instead of resolving it.

    ``count`` is max(hold_count, brake_count) PRE-escalation: a freshly
    cold-re-initialised agent (whose counter escalate_holds just
    zeroed) still retries its brand-new warm start at the reduced
    target, and separation-filter braking — whose solves are feasible
    and therefore invisible to hold_count — drives the same pass.
    Shape follows ``count`` (works batched/sharded). Exactly 1.0 when
    disabled or while an agent is below the rung."""
    if not cfg.hold_on_infeasible or cfg.hold_vx_frac is None:
        return jnp.ones(count.shape, dtype)
    k = cfg.hold_reset_k if cfg.hold_reset_k is not None else 3
    return jnp.where(count >= k,
                     jnp.asarray(cfg.hold_vx_frac, dtype),
                     jnp.ones(count.shape, dtype))


def escalate_holds(track: Track, cfg: ExperimentConfig, state, lanes):
    """Recovery escalation ladder, applied BEFORE the step's solve.

    Plan-holding (``hold_on_infeasible``) contains an infeasible solve by
    executing the previous plan one more stage — but an agent whose every
    retry fails would hold forever (the s=17.7 jam, round-3 study
    perturbed-start study). This is the fleet-path port of the reference
    MPCC driver's failure ladder (``mpc.cpp:231-252`` n_no_solves_ ->
    resetInitialGuess; ``runtime/racing.py`` n_reset):

    - ``count >= cfg.hold_reset_k``: reset the agent's ADMM warm state
      (w, y, rho_scale) so duals adapted to the pre-jam geometry stop
      poisoning the retry; the held plan stays the linearisation.
    - ``count >= cfg.hold_cold_k``: cold re-initialise the agent — a
      fresh constant-acceleration warm-start trajectory from its CURRENT
      state on its current lane (utils/warmstart.py, the reference's
      generateNewInitialGuess / predicted_vectors_generation) replaces the
      stale plan, warm state resets, and the hold budget restarts.

    ``count`` is max(hold_count, brake_count): sustained
    separation-filter braking escalates exactly like holding. A braked
    agent's carried/broadcast plan runs AHEAD of where it actually is
    (the filter executed less than one stage), so the whole cluster
    plans around phantom positions and can park at the floor forever —
    round-5 measured: two stressed starts froze for 361/476 steps with
    zero holds. The cold rung is the cure: the fresh warm start is
    anchored at the agent's ACTUAL (braked) pose, re-truthing the
    exchange.

    Generic over leading batch axes: works on (n_ag, ...) fleet states and
    (S_local, A_local, ...) sharded states alike (``hold_count``'s shape
    defines the batch shape). Identity when no agent is escalating.
    """
    if not cfg.hold_on_infeasible or (cfg.hold_reset_k is None
                                      and cfg.hold_cold_k is None):
        return state
    from colaborativempc_tpu.utils.warmstart import warmstart_trajectory
    hc = jnp.maximum(state.hold_count, state.brake_count)

    def bc(mask, ref):
        return mask.reshape(mask.shape + (1,) * (ref.ndim - mask.ndim))

    x_pred, u_pred = state.x_pred, state.u_pred
    hold_count, brake_count = state.hold_count, state.brake_count
    if cfg.hold_cold_k is not None:
        cold = hc >= cfg.hold_cold_k
        ws = lambda x, ln: warmstart_trajectory(  # noqa: E731
            track, x, cfg.N, cfg.dt, lane=ln)
        for _ in range(hc.ndim):
            ws = jax.vmap(ws)
        x_ws, u_ws = ws(state.x0, lanes)
        x_pred = jnp.where(bc(cold, x_pred), x_ws, x_pred)
        u_pred = jnp.where(bc(cold, u_pred), u_ws.astype(u_pred.dtype),
                           u_pred)
        hold_count = jnp.where(cold, 0, hold_count)
        brake_count = jnp.where(cold, 0, brake_count)
    else:
        cold = jnp.zeros(hc.shape, bool)
    reset = cold
    if cfg.hold_reset_k is not None:
        reset = reset | (hc >= cfg.hold_reset_k)
    w = jnp.where(bc(reset, state.w), jnp.zeros_like(state.w), state.w)
    y = jnp.where(bc(reset, state.y), jnp.zeros_like(state.y), state.y)
    rho_scale = jnp.where(bc(reset, state.rho_scale),
                          jnp.ones_like(state.rho_scale), state.rho_scale)
    return state._replace(x_pred=x_pred, u_pred=u_pred, w=w, y=y,
                          rho_scale=rho_scale, hold_count=hold_count,
                          brake_count=brake_count)


def make_lpv_fleet_step(track: Track, cfg: ExperimentConfig):
    """Build the jitted one-control-step function for the whole fleet."""
    gains = cfg.gains if cfg.gains is not None else lpv_gains()
    ns = jnp.asarray(_neighbour_index(cfg.n_agents))
    multi = cfg.n_agents > 1
    # full stage-scan unroll for the multi-agent fleet step at short
    # horizons, a caller-scoped default chosen by timings on another
    # accelerator (it slowed single-agent batches there); it awaits
    # re-measurement on the H100. An explicit SolverConfig.unroll pin
    # always wins.
    fleet_unroll = cfg.solver.unroll
    if fleet_unroll is None and multi and cfg.N <= 24:
        fleet_unroll = cfg.N
    limits_pa = _per_agent_limits(cfg)

    def one_agent(limits, lane, x0, x_lin, u_lin, u_old, w, y, rho_scale,
                  neighbours_xy, neigh_boost):
        # warm start w/y unshifted: empirically better than the one-stage
        # shift (the constraint geometry moves with the track, not the
        # stage index)
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

    def step(state: FleetState):
        if cfg.dynamic_lane:
            # per-step lane switch (reference set_lane/checkLane): each
            # agent's pose picks the lane, the Frenet entries of x0 AND the
            # linearisation trajectory are re-localised onto it so the QP's
            # curvature/half-width rows follow. The previously selected lane
            # is threaded as prev_lane so the lap count carried in s stays
            # exact across cross-lane switches when lanes differ in length
            # (geometry/frenet.py relocalize old_lane).
            from colaborativempc_tpu.geometry import relocalize, select_lane
            lanes, x0_new = jax.vmap(
                lambda x, pl: select_lane(track, x, prev_lane=pl))(
                state.x0, state.lane)
            x_pred = jax.vmap(lambda xs, ln, pl: jax.vmap(
                lambda x: relocalize(track, x, ln, old_lane=pl))(xs))(
                state.x_pred, lanes, state.lane)
            x_pred = x_pred.at[:, 0].set(x0_new)
            state = state._replace(x0=x0_new, x_pred=x_pred, lane=lanes)
        else:
            lanes = jnp.full((cfg.n_agents,), cfg.lane, jnp.int32)

        # recovery feasibility pass: pre-escalation hold-or-brake counts
        # (see hold_vx_scale) scale each agent's tracked speed this solve
        vxs = hold_vx_scale(
            cfg, jnp.maximum(state.hold_count, state.brake_count),
            state.x0.dtype)
        limits_step = limits_pa._replace(
            vx_ref=jnp.asarray(limits_pa.vx_ref) * vxs)

        state = escalate_holds(track, cfg, state, lanes)

        # the "communication": everyone reads everyone's (X, Y) plan
        # (reference LPV_HP_N_main.py:117 swapaxes; one all_gather on a mesh)
        agents_xy = jnp.swapaxes(state.x_pred[:, :, 7:9], 0, 1)  # (N+1,n,2)
        neigh = jnp.swapaxes(agents_xy[:, ns, :], 0, 1) if multi else (
            jnp.zeros((cfg.n_agents, cfg.N + 1, 0, 2), agents_xy.dtype))
        # neigh: (n_ag, N+1, n_nb, 2)

        # stale-broadcast hardening: push harder against neighbours that
        # are currently plan-holding (cfg.hold_sep_boost; exact no-op
        # when nobody holds). Boundary: the flags are read POST-escalation,
        # so an agent cold-re-initialised this very step (hold_count just
        # zeroed) draws no boost from its neighbours even though its
        # brand-new warm-start trajectory is the least-validated plan in
        # the exchange — acceptable while the knob defaults off (measured
        # ineffective against the observed near-passes, round-4 study);
        # derive from pre-escalation counts if it is ever defaulted on.
        boost_sc = cfg.hold_sep_boost if cfg.hold_on_infeasible else 0.0
        hold_f = (state.hold_count > 0).astype(agents_xy.dtype) * boost_sc
        neigh_boost = hold_f[ns] if multi else (
            jnp.zeros((cfg.n_agents, 1), agents_xy.dtype))

        sol: LPVSolution = jax.vmap(one_agent)(
            limits_step, lanes, state.x0, state.x_pred, state.u_pred,
            state.u_old, state.w, state.y, state.rho_scale, neigh,
            neigh_boost)

        jam_count = jnp.where(sol.feasible, 0, state.jam_count + 1)
        if cfg.hold_on_infeasible:
            # Solver-failure containment, the per-step analogue of what
            # every reference planner does on solver failure (MPCC guess
            # bookkeeping + reset, mpc.cpp:231-252; IPOPT last-iterate
            # debug-value fallback, NL_Planner_Eu.py:200-217): a plan whose
            # residual exceeded the feasibility tolerance is NOT executed.
            # The failed agent follows its PREVIOUS plan one more stage
            # (shift, terminal stage padded) and retries next step from
            # that saner linearisation; duals/penalties keep their
            # pre-failure warm state. Without this, a capped unconverged
            # solve in the Highway curve congestion executes garbage,
            # degrades the next linearisation, and the fleet deadlocks or
            # diverges (full-course study).
            # Degraded-execution escape (cfg.hold_exec_k): once the last
            # hold_exec_k solves ALL failed, holding has demonstrably
            # stopped helping — execute the unconverged plan, but ONLY
            # finite ones and ONLY through the sanitize_exec physical
            # envelope + the safety filters (raw degraded execution
            # NaN-diverged within a step, round-5 study).
            ok = sol.feasible
            degraded = jnp.zeros_like(ok)
            if cfg.hold_exec_k is not None:
                finite = (jnp.all(jnp.isfinite(sol.x_pred), axis=(1, 2))
                          & jnp.all(jnp.isfinite(sol.u_pred), axis=(1, 2)))
                degraded = ((~ok) & finite
                            & (state.jam_count >= cfg.hold_exec_k))
                ok = ok | degraded
            ok3 = ok[:, None, None]
            hold_x = jnp.concatenate(
                [state.x_pred[:, 1:], state.x_pred[:, -1:]], axis=1)
            hold_u = jnp.concatenate(
                [state.u_pred[:, 1:], state.u_pred[:, -1:]], axis=1)
            x_pred = jnp.where(ok3, sol.x_pred, hold_x)
            u_pred = jnp.where(ok3, sol.u_pred, hold_u)
            w = jnp.where(ok3, sol.w, state.w)
            y = jnp.where(ok3, sol.y, state.y)
            rho_scale = jnp.where(ok[:, None], sol.rho_scale,
                                  state.rho_scale)
            # hold_count tracks SOLVER feasibility (the ladder's input),
            # not the execution override — degraded-execution steps keep
            # escalating and keep the vx pass engaged
            hold_count = jnp.where(sol.feasible, 0, state.hold_count + 1)
        else:
            x_pred, u_pred = sol.x_pred, sol.u_pred
            w, y, rho_scale = sol.w, sol.y, sol.rho_scale
            hold_count = state.hold_count
            degraded = jnp.zeros(sol.feasible.shape, bool)

        # physical execution envelope (kinematic bounds + track-limits
        # wall), then the executed-separation safety filter (prediction
        # = plant: the applied x0-shift itself is projected; the plan
        # stays the linearisation exactly as under plan-holding)
        x0_cand, wall_clip = lateral_wall(track, cfg, state.x0,
                                          x_pred[:, 1, :], lanes)
        x0_exec, exec_beta = separation_filter(cfg, state.x0, x0_cand)
        brake_count = jnp.where(exec_beta < 1.0, state.brake_count + 1,
                                jnp.zeros_like(state.brake_count))
        new_state = FleetState(
            x0=x0_exec,                    # x0 shift (prediction = plant)
            x_pred=x_pred, u_pred=u_pred,
            u_old=u_pred[:, 0, :],
            w=w, y=y, rho_scale=rho_scale,
            lane=lanes, hold_count=hold_count, brake_count=brake_count,
            jam_count=jam_count)
        exec_xy = x0_exec[:, 7:9]                     # applied next states
        dd = exec_xy[:, None, :] - exec_xy[None, :, :]
        dexec = jnp.sqrt(jnp.sum(dd * dd, axis=-1) + 1e-12)
        dexec = dexec + jnp.eye(dexec.shape[0]) * 1e9
        metrics = StepMetrics(
            feasible=sol.feasible, iterations=sol.iterations,
            r_prim=sol.r_prim,
            min_dist=_pairwise_min_dist(
                jnp.swapaxes(x_pred[:, :, 7:9], 0, 1)),
            min_dist_exec=jnp.min(dexec),
            slack_max=jnp.max(jnp.abs(sol.s_pred), axis=(1, 2)),
            exec_beta=exec_beta, wall_clip=wall_clip)
        return new_state, metrics

    return jax.jit(step)


def make_lpv_fleet_rollout(track: Track, cfg: ExperimentConfig, steps: int):
    """Fixed-step fully-on-device closed-loop rollout: ``lax.scan`` over
    control steps, so a whole experiment (or a sweep/Monte-Carlo chunk) is
    ONE device program with no host dispatch between steps — at small batch
    sizes a dispatch per step can cost more than the solves. The
    reference's outer loop is host Python by construction
    (``LPV_HP_N_main.py:96``); this is the on-device alternative for
    fixed-step workloads (benchmarks, sweeps). ``run_lpv_experiment`` keeps
    the host loop for data-dependent termination + IO.

    Returns a jitted ``state -> (final_state, (x0_hist, u_hist, metrics))``
    with ``(steps, ...)`` leading axes on the history outputs.
    """
    step = make_lpv_fleet_step(track, cfg)

    def rollout(state: FleetState):
        def body(st, _):
            st2, m = step(st)
            return st2, (st2.x0, st2.u_old, m)
        return jax.lax.scan(body, state, None, length=steps)

    return jax.jit(rollout)


def init_lpv_fleet(track: Track, cfg: ExperimentConfig,
                   x0s: Optional[np.ndarray] = None) -> FleetState:
    dtype = jnp.float32 if cfg.dtype == "float32" else jnp.float64
    if x0s is None:
        x0s = x0_database(cfg.n_agents)
    x0s = jnp.asarray(x0s, dtype)
    _, x_pred, u_pred = initialise_agents(track, x0s, cfg.N, cfg.dt,
                                          lane=cfg.lane)
    n_nb = cfg.n_agents - 1 if cfg.n_agents > 1 else 1
    m = 4 + n_nb
    # x0 = warmstart row 0, whose (X, Y, theta) are recomputed from the track
    # geometry — the raw x0 database rows carry Cartesian fields inconsistent
    # with their Frenet fields, and the reference also feeds the corrected
    # row to the planner (LPV_HP_N_main.py:92 uses x_old[i][0, :]).
    return FleetState(
        x0=x_pred[:, 0, :], x_pred=x_pred, u_pred=u_pred,
        u_old=jnp.zeros((cfg.n_agents, 2), dtype),
        w=jnp.zeros((cfg.n_agents, cfg.N, m), dtype),
        y=jnp.zeros((cfg.n_agents, cfg.N, m), dtype),
        rho_scale=jnp.ones((cfg.n_agents, m), dtype),
        lane=jnp.full((cfg.n_agents,), cfg.lane, jnp.int32),
        hold_count=jnp.zeros((cfg.n_agents,), jnp.int32),
        brake_count=jnp.zeros((cfg.n_agents,), jnp.int32),
        jam_count=jnp.zeros((cfg.n_agents,), jnp.int32))


class ExperimentResult(NamedTuple):
    states: np.ndarray      # (T, n_ag, 9) applied states per step
    inputs: np.ndarray      # (T, n_ag, 2)
    feasible: np.ndarray    # (T, n_ag)
    min_dist: np.ndarray    # (T,) over predictions
    min_dist_exec: np.ndarray  # (T,) over executed states
    step_times: np.ndarray  # (T,) wall clock per control step
    iterations: np.ndarray  # (T, n_ag) ADMM iterations
    steps: int
    finished: bool          # lap completed (vs max_it exhausted)
    exec_beta: np.ndarray = np.ones((0, 0))  # (T, n_ag) separation-filter
    #                          advance fractions (1.0 = filter inactive)
    wall_clip: np.ndarray = np.zeros((0, 0), bool)  # (T, n_ag) lateral
    #                          wall clamps


def resolve_single_fleet_schedule(cfg: ExperimentConfig) -> ExperimentConfig:
    """Fill unset solver knobs with the single-fleet long-horizon (N>=48)
    latency schedule. Host-loop entry points run ONE fleet per step;
    batched/sharded paths keep the long-epoch sequential throughput
    defaults (the batch pays its slowest problem's epochs and the
    associative path streams through HBM, so both choices flip there).

    Chosen at N=125:
      - epoch_len 15: frequent rho adaptation roughly halves warm
        iteration counts vs the batch-tuned epoch 30;
      - assoc (blocked log-depth Riccati, ops/lqr.py): lower latency than
        the sequential scan at equal tolerance on the accelerator it was
        chosen on; its effect on the H100 awaits measurement;
      - admm_iters >= 1000: the Highway hard window (three agents
        entering the k=0.35 curve at s=25-33) needs 600-1000 iterations
        on a few steps; a 300-cap executes unconverged plans there until
        the fleet deadlocks and diverges (full-course study).
        The reference runs OSQP with max_iter=500000 (LPV_Planner.py:233)
        — budget-capped it is not. Early exit on residuals makes the
        higher cap free on easy steps.

    Each knob only fills in when left unset (None); pin
    solver.epoch_len / assoc / admm_iters to override — an explicit
    admm_iters=300 stays 300 (None-sentinel, SolverConfig.admm_budget).
    """
    if cfg.N < 48:
        return cfg
    import dataclasses
    sv = cfg.solver
    return dataclasses.replace(cfg, solver=sv._replace(
        epoch_len=15 if sv.epoch_len is None else sv.epoch_len,
        assoc=True if sv.assoc is None else sv.assoc,
        admm_iters=1000 if sv.admm_iters is None else sv.admm_iters))


def run_lpv_experiment(cfg: ExperimentConfig,
                       x0s: Optional[np.ndarray] = None,
                       track: Optional[Track] = None,
                       io=None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 50,
                       profile_dir: Optional[str] = None) -> ExperimentResult:
    """Closed-loop decentralised LPV experiment (reference
    ``LPV_HP_N_main.main``). The host loop handles termination + IO; all
    per-step compute is one jitted call.

    ``checkpoint_path`` enables exact mid-run resume (runtime/checkpoint.py);
    ``profile_dir`` wraps the loop in a jax.profiler trace (the framework's
    tracing hook; the reference only had wall-clock tables, SURVEY.md §5.1).
    """
    from colaborativempc_tpu.runtime.checkpoint import (
        save_checkpoint, load_checkpoint,
    )
    from colaborativempc_tpu.utils.precision import dtype_island
    if cfg.dtype == "float64" and not jax.config.jax_enable_x64:
        # float64 experiments run as a scoped x64 island (the reference's
        # solvers are f64, LPV_Planner.py:222-239; utils/precision.py)
        with dtype_island(cfg.dtype):
            return run_lpv_experiment(cfg, x0s, track, io, checkpoint_path,
                                      checkpoint_every, profile_dir)
    cfg = resolve_single_fleet_schedule(cfg)
    if track is None:
        track = make_track(cfg.map_type,
                           dtype=jnp.float64 if cfg.dtype == "float64"
                           else jnp.float32)
    state = init_lpv_fleet(track, cfg, x0s)
    it = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, it = load_checkpoint(checkpoint_path, state)
    step = make_lpv_fleet_step(track, cfg)
    if profile_dir is not None:
        jax.profiler.start_trace(profile_dir)

    states, inputs, feas_h, dist_h, times, iters_h = [], [], [], [], [], []
    dist_exec_h, beta_h, wall_h = [], [], []
    finished = False
    while it < cfg.max_it:
        t0 = time.time()
        state, metrics = step(state)
        state = jax.block_until_ready(state)
        times.append(time.time() - t0)

        states.append(np.asarray(state.x0))
        inputs.append(np.asarray(state.u_old))
        feas_h.append(np.asarray(metrics.feasible))
        dist_h.append(float(metrics.min_dist))
        dist_exec_h.append(float(metrics.min_dist_exec))
        beta_h.append(np.asarray(metrics.exec_beta))
        wall_h.append(np.asarray(metrics.wall_clip))
        iters_h.append(np.asarray(metrics.iterations))
        if io is not None:
            io.update(it, state, metrics, times[-1])

        # Abort semantics mirror the reference's LPV loop: OSQP statuses
        # solved / solved_inaccurate / max_iter_reached are ALL treated as
        # feasible and the loop continues (LPV_Planner.py:241-249 +
        # LPV_HP_N_main.py:102-104); only a hard solver failure stops the
        # experiment. The ADMM analogue of max_iter_reached is a finite
        # solution with residuals above tolerance — continue on it (the
        # per-step feasible flags are still recorded), abort on non-finite.
        if not bool(np.all(np.isfinite(states[-1]))):
            break
        if cfg.verb >= 1 and not bool(np.all(feas_h[-1])):
            bad = np.where(~np.asarray(feas_h[-1]))[0].tolist()
            print(f"[step {it}] inaccurate solve accepted (agents {bad})")
        # lap termination on any agent (reference checkEnd, misc.py:28-48)
        if bool(np.any(np.asarray(
                check_end(track, state.x0[:, 6], laps=cfg.laps,
                          lane=cfg.lane)))):
            finished = True
            break
        it += 1
        if checkpoint_path is not None and it % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state, it)

    if profile_dir is not None:
        jax.profiler.stop_trace()
    if checkpoint_path is not None:
        save_checkpoint(checkpoint_path, state, it)
    return ExperimentResult(
        states=np.asarray(states), inputs=np.asarray(inputs),
        feasible=np.asarray(feas_h), min_dist=np.asarray(dist_h),
        min_dist_exec=np.asarray(dist_exec_h),
        step_times=np.asarray(times), iterations=np.asarray(iters_h),
        steps=len(states), finished=finished,
        exec_beta=np.asarray(beta_h), wall_clip=np.asarray(wall_h))
