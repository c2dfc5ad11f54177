"""LPV collaborative MPC planner (the reference's QP planner family).

On-device re-design of ``PlannerLPV``
(``planner/lib/plan_lib/distributedPlanner/LPV_Planner.py``): instead of
assembling one big sparse QP (block_diag loops, :279-475) and calling OSQP
(:192-249), the problem is kept in its natural stage structure — an
11-dim augmented state z = [x (9); u_prev (2)], a 2-dim stage control
c = du — built by one vmap over stages and solved on-device by the
Riccati+ADMM engine (ops/). Collision avoidance enters exactly as in the
reference: geometric separating hyperplanes as per-stage linear rows
(:251-276) plus a distance-weighted linear separation reward (:416-422).

Slack handling: the reference adds 3 slack decision variables per stage with
weight Qs ~ 1e7 (:294-303). Here each slacked constraint becomes a SOFT row
of the stage QP (ops/admm.py soft bounds) — the analytically identical
formulation (a quadratically-penalised slack on a single row IS a soft
constraint) that keeps the 1e7 weights out of the Riccati matrices, which
matters for float32 conditioning. One deviation: the reference shares
one obstacle slack across all neighbours of a stage (K[i,-1] = -1 for every
i, :271), i.e. penalises the max violation; we penalise each pair's
violation, which upper-bounds the reference's penalty.

Decision-variable correspondence with the reference packing (:164-176):
    xPred  = z[:, :9]
    uPred  = z[1:, 9:11]          (u_k lives in z_{k+1})
    duPred = c
    sPred  -> reported as realised constraint violations
Constraints on x_{k+1} are stage-local in (z_k, c_k) through the dynamics
row composition — state stage 0 is fixed and unconstrained, matching
LPV_Planner.py:317.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from colaborativempc_tpu.config.params import Gains, ModelParams, SysLimits
from colaborativempc_tpu.dynamics.bicycle import NX, NU, lpv_discrete_horizon
from colaborativempc_tpu.geometry import (
    Track, curvature, halfwidth, compute_hyperplanes, separation_weights,
)
from colaborativempc_tpu.ops import (
    LQRCost, LQRDynamics, StageQP, admm_solve, ADMMSolution,
)

NZ = NX + NU          # augmented state dim
NC = NU               # stage control = du
INF = jnp.inf


class LPVSolution(NamedTuple):
    x_pred: jnp.ndarray    # (N+1, 9)
    u_pred: jnp.ndarray    # (N, 2)
    du_pred: jnp.ndarray   # (N, 2)
    s_pred: jnp.ndarray    # (N, 3) realised violations (vel, ey, planes)
    planes: jnp.ndarray    # (N, n_nb, 3)
    feasible: jnp.ndarray  # scalar bool
    w: jnp.ndarray         # ADMM splitting state (warm start for next step)
    y: jnp.ndarray
    rho_scale: jnp.ndarray # adaptive-rho state (warm start for next step)
    iterations: jnp.ndarray
    r_prim: jnp.ndarray


def _augment_dynamics(Ad: jnp.ndarray, Bd: jnp.ndarray):
    """Lift (A, B) to the [x; u_prev] system with control du."""
    N = Ad.shape[0]
    dtype = Ad.dtype
    F = jnp.zeros((N, NZ, NZ), dtype)
    F = F.at[:, :NX, :NX].set(Ad)
    F = F.at[:, :NX, NX:].set(Bd)
    F = F.at[:, NX:, NX:].set(jnp.eye(NU, dtype=dtype))
    G = jnp.zeros((N, NZ, NC), dtype)
    G = G.at[:, :NX, :].set(Bd)
    G = G.at[:, NX:, :].set(jnp.eye(NU, dtype=dtype))
    d = jnp.zeros((N, NZ), dtype)
    return LQRDynamics(F=F, G=G, d=d)


#: Cap on effective soft-constraint weights. The reference uses Qs = 1e7
#: (config_LPV.py:6) which OSQP tolerates in float64 direct solves; here
#: (float32, first-order splitting) that stiffness costs hundreds of dual
#: iterations for zero behavioural gain — the binding forces are O(100), so
#: 1e4 already keeps violations at the ~5e-3 level, below solver tolerance.
SOFT_WEIGHT_CAP = 1e4


def build_lpv_qp(track: Track, gains: Gains, limits: SysLimits,
                 model: ModelParams, N: int, dt,
                 x_lin: jnp.ndarray, u_lin: jnp.ndarray,
                 planes: jnp.ndarray, weights: jnp.ndarray,
                 lane: int = 0) -> StageQP:
    """Assemble the stage QP around linearisation trajectory (x_lin, u_lin).

    planes: (N, n_nb, 3) separating planes; weights: (N, n_nb) separation
    reward weights (pass zeros for a single agent).
    """
    gains = gains._replace(qs=jnp.minimum(gains.qs, SOFT_WEIGHT_CAP))
    dtype = x_lin.dtype
    kappas = curvature(track, x_lin[:N, 6], lane)
    Ad, Bd = lpv_discrete_horizon(x_lin[:N], u_lin, kappas, dt, model)
    dyn = _augment_dynamics(Ad, Bd)

    # ---- cost ------------------------------------------------------------
    # stage quadratic on z (states 1..N incl. terminal): Q on x, R on u_prev
    Qz_diag = jnp.concatenate([2.0 * gains.q, 2.0 * gains.r]).astype(dtype)
    Q = jnp.zeros((N + 1, NZ, NZ), dtype)
    Q = Q.at[1:].set(jnp.diag(Qz_diag))
    R = jnp.broadcast_to(jnp.diag(2.0 * gains.dr.astype(dtype)), (N, NC, NC))
    S = jnp.zeros((N, NZ, NC), dtype)

    # linear terms: vx tracking + separation reward on (X, Y)
    q = jnp.zeros((N + 1, NZ), dtype)
    q = q.at[1:, 0].set(-2.0 * gains.q[0] * limits.vx_ref)
    # reward index k (state stage k+1) uses weights row k, planes row k
    # (reference _buildMatCost: Px_total[t*n_exp + 7] += wq*w[t-1]*a[t-1])
    rew_x = 2.0 * gains.wq * jnp.sum(weights * planes[:, :, 0], axis=-1)
    rew_y = 2.0 * gains.wq * jnp.sum(weights * planes[:, :, 1], axis=-1)
    q = q.at[1:, 7].add(rew_x.astype(dtype))
    q = q.at[1:, 8].add(rew_y.astype(dtype))
    r = jnp.zeros((N, NC), dtype)
    cost = LQRCost(Q=Q, q=q, R=R, r=r, S=S)

    # ---- constraints -----------------------------------------------------
    n_nb = planes.shape[1]
    m = 4 + n_nb
    D = jnp.zeros((N, m, NZ), dtype)
    E = jnp.zeros((N, m, NC), dtype)
    lo = jnp.full((N, m), -INF, dtype)
    hi = jnp.full((N, m), INF, dtype)
    soft_lo = jnp.full((N, m), INF, dtype)
    soft_hi = jnp.full((N, m), INF, dtype)

    F_, G_ = dyn.F, dyn.G

    def next_state_rows(j):
        """(D, E) coefficients of x_{k+1}[j] as a stage-local row."""
        return F_[:, j, :], G_[:, j, :]

    # velocity: hard min_vel <= vx_{k+1} <= max_vel (soft upper, Qs[0])
    Dv, Ev = next_state_rows(0)
    D = D.at[:, 0, :].set(Dv); E = E.at[:, 0, :].set(Ev)
    lo = lo.at[:, 0].set(limits.min_vel)
    hi = hi.at[:, 0].set(limits.max_vel)
    soft_hi = soft_hi.at[:, 0].set(gains.qs[0])

    # lateral error band, soft on both sides with the shared ey slack weight
    # (LPV_Planner.py:299-303)
    ey_ub = (halfwidth(track, x_lin[:N, 6], lane, sm=limits.sm)).astype(dtype)
    Dey, Eey = next_state_rows(3)
    D = D.at[:, 1, :].set(Dey); E = E.at[:, 1, :].set(Eey)
    lo = lo.at[:, 1].set(-ey_ub); hi = hi.at[:, 1].set(ey_ub)
    soft_lo = soft_lo.at[:, 1].set(gains.qs[1])
    soft_hi = soft_hi.at[:, 1].set(gains.qs[1])

    # inputs: u_k = u_prev + du, hard box (LPV_Planner.py:331-339)
    D = D.at[:, 2, NX + 0].set(1.0); E = E.at[:, 2, 0].set(1.0)
    lo = lo.at[:, 2].set(-limits.max_ls); hi = hi.at[:, 2].set(limits.max_rs)
    D = D.at[:, 3, NX + 1].set(1.0); E = E.at[:, 3, 1].set(1.0)
    lo = lo.at[:, 3].set(-limits.max_dc); hi = hi.at[:, 3].set(limits.max_ac)

    # collision avoidance: a . p_{k+1} <= -D/2 - b, soft (Qs[2])
    # (LPV_Planner.py:263-272)
    Dx_, Ex_ = next_state_rows(7)
    Dy_, Ey_ = next_state_rows(8)
    ax = planes[:, :, 0]; ay = planes[:, :, 1]; b = planes[:, :, 2]
    Dpl = (ax[:, :, None] * Dx_[:, None, :] + ay[:, :, None] * Dy_[:, None, :])
    Epl = (ax[:, :, None] * Ex_[:, None, :] + ay[:, :, None] * Ey_[:, None, :])
    D = D.at[:, 4:, :].set(Dpl.astype(dtype))
    E = E.at[:, 4:, :].set(Epl.astype(dtype))
    hi = hi.at[:, 4:].set((-limits.min_dist / 2.0 - b).astype(dtype))
    soft_hi = soft_hi.at[:, 4:].set(gains.qs[2])

    return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                   soft_lo=soft_lo, soft_hi=soft_hi)


def _violations(qp: StageQP, z: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Realised soft-constraint violations, reported like the reference's
    slack predictions sPred (vel, ey, planes)."""
    v = (jnp.einsum("kmi,ki->km", qp.D, z[:-1],
                    precision=jax.lax.Precision.HIGHEST)
         + jnp.einsum("kmi,ki->km", qp.E, c,
                      precision=jax.lax.Precision.HIGHEST))
    over = jnp.maximum(v - qp.hi, 0.0) + jnp.maximum(qp.lo - v, 0.0)
    s_vel = over[:, 0]
    s_ey = over[:, 1]
    s_planes = jnp.max(over[:, 4:], axis=-1)
    return jnp.stack([s_vel, s_ey, s_planes], axis=-1)


def lpv_solve(track: Track, gains: Gains, limits: SysLimits,
              model: ModelParams, N: int, dt,
              x0: jnp.ndarray, x_lin: jnp.ndarray, u_lin: jnp.ndarray,
              u_old: jnp.ndarray, neighbours_xy: Optional[jnp.ndarray],
              ego_xy: Optional[jnp.ndarray] = None,
              w0=None, y0=None, rho_scale0=1.0,
              admm_iters: int = 100, rho: float = 10.0,
              alpha_relax: float = 1.6,
              eps: float = 1e-4, lane: int = 0,
              epoch_len=None, unroll=None,
              assoc: bool = False,
              neigh_boost=None) -> LPVSolution:
    """One LPV-MPC solve (the reference ``PlannerLPV.solve``, :115-182).

    Args:
      x0: (9,) current state. x_lin/u_lin: previous predictions used for
        linearisation and plane generation. u_old: (2,) previously applied
        input. neighbours_xy: (N+1, n_nb, 2) neighbour plans or None.
      ego_xy: (N+1, 2) ego plan positions used for plane generation
        (defaults to x_lin's X, Y columns).
      neigh_boost: optional (n_nb,) per-neighbour separation-reward
        multiplier-minus-one (the fleet step passes hold_sep_boost for
        neighbours currently plan-holding — their broadcast plans are
        stale, so ego pushes away harder; cfg.hold_sep_boost). Only
        repulsive (positive) weights are scaled.
    """
    dtype = x_lin.dtype
    if neighbours_xy is None:
        planes = jnp.zeros((N, 1, 3), dtype)
        weights = jnp.zeros((N, 1), dtype)
    else:
        if ego_xy is None:
            ego_xy = x_lin[:, 7:9]
        planes = compute_hyperplanes(ego_xy[:N], neighbours_xy[:N],
                                     keep_sign=True)
        weights, _ = separation_weights(ego_xy[1:], neighbours_xy[1:],
                                        limits.min_dist)
        if neigh_boost is not None:
            weights = jnp.where(
                weights > 0,
                weights * (1.0 + neigh_boost)[None, :].astype(dtype),
                weights)

    qp = build_lpv_qp(track, gains, limits, model, N, dt, x_lin, u_lin,
                      planes, weights, lane=lane)
    if neighbours_xy is None:
        # disable the placeholder plane row
        qp = qp._replace(hi=qp.hi.at[:, 4:].set(INF))

    z0 = jnp.concatenate([x0, u_old]).astype(dtype)
    sol: ADMMSolution = admm_solve(qp, z0, w0=w0, y0=y0,
                                   rho_scale0=rho_scale0,
                                   iters=admm_iters, rho=rho,
                                   alpha=alpha_relax, eps=eps,
                                   epoch_len=epoch_len, unroll=unroll,
                                   assoc=assoc)

    x_pred = sol.z[:, :NX]
    u_pred = sol.z[1:, NX:]
    return LPVSolution(
        x_pred=x_pred, u_pred=u_pred,
        du_pred=sol.c, s_pred=_violations(qp, sol.z, sol.c),
        planes=planes, feasible=sol.feasible,
        w=sol.w, y=sol.y, rho_scale=sol.rho_scale,
        iterations=sol.iterations, r_prim=sol.r_prim)
