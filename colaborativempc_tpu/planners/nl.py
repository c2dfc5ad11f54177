"""Nonlinear collaborative MPC planners (the reference's NLP family).

On-device re-design of ``base_nl_constr`` + ``PlannerEu``
(``planner/lib/plan_lib/nonLinDistribPlanner/base_nl.py``,
``NL_Planner_Eu.py``): instead of a CasADi Opti graph solved by IPOPT
(NL_Planner_Eu.py:172-183), the nonlinear OCP is solved by SQP — autodiff
linearisation of the analytic bicycle dynamics around the incumbent
trajectory, each inner QP solved by the stage-structured Riccati+ADMM engine
(ops/). This mirrors the architecture the reference itself uses natively
(the C++ MPCC SQP loop, MPCC-master/C++/MPC/mpc.cpp:232-242), and SQP with 1
iteration reproduces the real-time-iteration trick the reference pulls with
``max_iter: 1`` IPOPT (NL_Planner_Hp.py:218).

OCD sub-problem structure (NL_Planner_Eu.py):
- tracking/rate/slack cost as in the reference ``cost`` (:16-52). The
  reference also adds copies of the NEIGHBOURS' costs built from parameters
  (:32-42); those are constant w.r.t. the ego's decision variables and
  cannot change the minimiser, so they are omitted here.
- master side (ego id < neighbour id): the coupling price
  lambda_{i,k} * (dth - ||p_ego - p_neigh||) enters the cost (:45-47);
  linearised per SQP iteration it contributes -lambda * g_hat to the linear
  cost on (X, Y), g_hat = unit vector from neighbour to ego.
- slave side (ego id > neighbour id): hard distance constraint
  ||p_ego - p_neigh|| + s >= dth with quadratically penalised slack
  (:68-71); linearised it is a soft lower-bound row
  g_hat . p >= dth - ||p_bar - p_n|| + g_hat . p_bar.
Role asymmetry is expressed as masks over a dense neighbour tensor so every
agent runs the same program (batched over the fleet), unlike the reference
where each agent's CasADi graph has a different shape.

Alignment note: the reference pairs ego stage j with neighbour stage j-1 in
the coupling terms (update_parameters feeds pose_param[j-1] = neighbour
stage j-1 against x[j], base_nl.py:417-425) while the dual update uses
same-stage pairs (NL_EU_N_main.py:130-135); we use same-stage alignment for
both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from colaborativempc_tpu.config.params import Gains, ModelParams, SysLimits
from colaborativempc_tpu.dynamics.bicycle import NX, NU, f_continuous
from colaborativempc_tpu.geometry import Track, curvature, halfwidth
from colaborativempc_tpu.ops import (
    LQRCost, LQRDynamics, StageQP, admm_solve, ADMMSolution,
)
from colaborativempc_tpu.planners.lpv import (
    NZ, NC, SOFT_WEIGHT_CAP, _augment_dynamics,
)

INF = jnp.inf
_EPS = 1e-6


class NLSolution(NamedTuple):
    x_pred: jnp.ndarray    # (N+1, 9)
    u_pred: jnp.ndarray    # (N, 2)
    du_pred: jnp.ndarray   # (N, 2)
    s_pred: jnp.ndarray    # (N, 3) realised violations (vel, ey, distance)
    feasible: jnp.ndarray
    w: jnp.ndarray
    y: jnp.ndarray
    rho_scale: jnp.ndarray
    iterations: jnp.ndarray
    r_prim: jnp.ndarray
    planes: jnp.ndarray    # (n_nb, N, 2) refined (theta, b) — hp_opt only


# trust region on the per-SQP-iteration plane perturbation (hp_opt):
# keeps the linearisation a(theta_bar + dtheta) ~ a + a' dtheta valid
PLANE_TRUST_THETA = 0.3   # [rad]
PLANE_TRUST_B = 0.2       # [m]
PLANE_REG = 0.1           # quadratic regularisation on (dtheta, db)


def _linearize_horizon(x_bar: jnp.ndarray, u_bar: jnp.ndarray,
                       kappas: jnp.ndarray, dt, model: ModelParams):
    """Autodiff linearisation of the Euler-discretised nonlinear dynamics
    around (x_bar, u_bar): x_{k+1} ~= Ad x + Bd u + rd."""

    def fd(x, u, k):
        return x + dt * f_continuous(x, u, k, model)

    def one(x, u, k):
        Ad = jax.jacfwd(fd, argnums=0)(x, u, k)
        Bd = jax.jacfwd(fd, argnums=1)(x, u, k)
        hi = jax.lax.Precision.HIGHEST
        rd = (fd(x, u, k) - jnp.matmul(Ad, x, precision=hi)
              - jnp.matmul(Bd, u, precision=hi))
        return Ad, Bd, rd

    return jax.vmap(one)(x_bar, u_bar, kappas)


def build_nl_qp(track: Track, gains: Gains, limits: SysLimits,
                model: ModelParams, N: int, dt,
                x_bar: jnp.ndarray, u_bar: jnp.ndarray,
                lambdas: jnp.ndarray, neigh_xy: jnp.ndarray,
                master_mask: jnp.ndarray,
                u_trust: Optional[tuple] = (0.06, 0.6),
                coupling: str = "eu", lane: int = 0,
                planes0: Optional[jnp.ndarray] = None) -> StageQP:
    """Assemble the SQP inner QP around (x_bar, u_bar).

    Args:
      lambdas: (n_nb, N) coupling prices for each neighbour and stage.
      neigh_xy: (N+1, n_nb, 2) neighbour plans (stage-aligned).
      master_mask: (n_nb,) 1.0 where ego id < neighbour id (price in cost),
        0.0 where ego is the slave (hard linearised distance row).
      coupling: "eu" (Euclidean distance, reference NL_Planner_Eu.py),
        "hp" (separating hyperplanes, reference NL_Planner_Hp.py) or
        "hp_opt" (hyperplanes as DECISION variables, the reference's full
        Hp master formulation, NL_Planner_Hp.py:89-98 + 143-149). For "hp"
        every agent gets a plane row against every neighbour: the geometric
        sign-flipped bisector each side computes coincides with the plane
        the reference's master optimises and ships to slaves
        (compute_plane.py:56-63), so the coupling becomes the symmetric
        pair of soft rows  a.p_ego <= -dth/2 - b  (master side) and
        a.p_ego >= +dth/2 - b after the sign flip (slave side), with the
        dual price entering as half the Euclidean gradient (the bisector
        moves at half the rate of the distance).
      planes0: hp_opt only — (n_nb, N, 2) incumbent planes (theta, b) per
        neighbour/stage in CANONICAL pair orientation (normal a(theta) =
        (cos, sin) points master -> slave, so a.p + b = -dist/2 on the
        master and +dist/2 on the slave). The master's plane perturbations
        (dtheta, db) are appended to the stage controls — parameterising by
        angle keeps ||a|| = 1 EXACTLY, where the reference needs the
        nonconvex equality a_x^2 + a_y^2 == 1 (NL_Planner_Hp.py:92). The
        ego's own side is a soft row that sees both its position and its
        plane controls; the slave's side enters the master's LINEAR cost
        priced by lambda (the reference's lambdas*(-(a.p_n + b - dth/2)),
        NL_Planner_Hp.py:58-60); slaves see the shipped plane as a
        parameter row (NL_Planner_Hp.py:97).
    """
    gains = gains._replace(qs=jnp.minimum(gains.qs, SOFT_WEIGHT_CAP))
    dtype = x_bar.dtype
    n_nb = neigh_xy.shape[1]

    hp_opt = coupling == "hp_opt"
    # hp_opt: the master's plane perturbations (dtheta, db) per neighbour
    # are stage-local DECISION variables appended to the controls
    nc = NC + (2 * n_nb if hp_opt else 0)

    kappas = curvature(track, x_bar[:N, 6], lane)
    Ad, Bd, rd = _linearize_horizon(x_bar[:N], u_bar, kappas, dt, model)
    dyn = _augment_dynamics(Ad, Bd)
    dyn = dyn._replace(d=dyn.d.at[:, :NX].set(rd))
    if hp_opt:
        # plane controls do not enter the dynamics: zero G columns
        G_ext = jnp.zeros((N, NZ, nc), dtype).at[:, :, :NC].set(dyn.G)
        dyn = dyn._replace(G=G_ext)

    # ---- cost (NL_Planner_Eu.py:23-30) -----------------------------------
    Qz_diag = jnp.concatenate([2.0 * gains.q, 2.0 * gains.r]).astype(dtype)
    Q = jnp.zeros((N + 1, NZ, NZ), dtype)
    Q = Q.at[1:].set(jnp.diag(Qz_diag))
    R_diag = jnp.concatenate([
        2.0 * gains.dr.astype(dtype),
        jnp.full((nc - NC,), 2.0 * PLANE_REG, dtype)])
    R = jnp.broadcast_to(jnp.diag(R_diag), (N, nc, nc))
    S = jnp.zeros((N, NZ, nc), dtype)

    q = jnp.zeros((N + 1, NZ), dtype)
    q = q.at[1:, 0].set(-2.0 * gains.q[0] * limits.vx_ref)

    # master coupling price: d/dp [-lambda * ||p - p_n||] = -lambda * g_hat
    # ("hp": the plane term's position gradient is half of that;
    #  "hp_opt": the price acts on the PLANE controls instead, below)
    p_bar = x_bar[1:, 7:9]                                  # (N, 2)
    diff = p_bar[:, None, :] - neigh_xy[1:]                 # (N, n_nb, 2)
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + _EPS)   # (N, n_nb)
    g_hat = diff / dist[..., None]
    price_scale = 0.5 if coupling == "hp" else 1.0
    lam = (price_scale * jnp.swapaxes(lambdas, 0, 1)
           * master_mask[None, :])                          # (N, n_nb)
    r = jnp.zeros((N, nc), dtype)
    if hp_opt:
        # incumbent planes (canonical orientation master -> slave)
        th_bar = jnp.swapaxes(planes0[..., 0], 0, 1)        # (N, n_nb)
        b_bar = jnp.swapaxes(planes0[..., 1], 0, 1)         # (N, n_nb)
        a_x, a_y = jnp.cos(th_bar), jnp.sin(th_bar)
        ap_x, ap_y = -jnp.sin(th_bar), jnp.cos(th_bar)      # a'(theta)
        # lambda prices the SLAVE's side of the MASTER's plane
        # (NL_Planner_Hp.py:58-60): J += lam * (-(a.p_n + b - dth/2))
        # => linear cost -lam*(a'.p_n) on dtheta and -lam on db
        ap_pn = (ap_x * neigh_xy[1:, :, 0]
                 + ap_y * neigh_xy[1:, :, 1])               # (N, n_nb)
        r = r.at[:, NC:NC + n_nb].set((-lam * ap_pn).astype(dtype))
        r = r.at[:, NC + n_nb:].set((-lam).astype(dtype))
    else:
        q = q.at[1:, 7].add(
            -jnp.sum(lam * g_hat[..., 0], axis=-1).astype(dtype))
        q = q.at[1:, 8].add(
            -jnp.sum(lam * g_hat[..., 1], axis=-1).astype(dtype))
    cost = LQRCost(Q=Q, q=q, R=R, r=r, S=S)

    # ---- constraints -----------------------------------------------------
    m = 4 + (3 * n_nb if hp_opt else n_nb)
    D = jnp.zeros((N, m, NZ), dtype)
    E = jnp.zeros((N, m, nc), dtype)
    lo = jnp.full((N, m), -INF, dtype)
    hi = jnp.full((N, m), INF, dtype)
    soft_lo = jnp.full((N, m), INF, dtype)
    soft_hi = jnp.full((N, m), INF, dtype)

    F_, G_ = dyn.F, dyn.G
    d_ = dyn.d  # rows composed through the dynamics see x_{k+1} - d_k, so
    #             every bound below must be shifted by the row's d-part

    def next_state_rows(j):
        return F_[:, j, :], G_[:, j, :], d_[:, j]

    # velocity band, soft BOTH sides (base_nl slack_agent[:,1],
    # NL_Planner_Eu.py:60)
    Dv, Ev, dv = next_state_rows(0)
    D = D.at[:, 0, :].set(Dv); E = E.at[:, 0, :].set(Ev)
    lo = lo.at[:, 0].set(limits.min_vel - dv)
    hi = hi.at[:, 0].set(limits.max_vel - dv)
    soft_lo = soft_lo.at[:, 0].set(gains.qs[0])
    soft_hi = soft_hi.at[:, 0].set(gains.qs[0])

    # lateral error band, soft both sides (NL_Planner_Eu.py:62)
    ey_ub = (halfwidth(track, x_bar[:N, 6], lane, sm=limits.sm)).astype(dtype)
    Dey, Eey, dey = next_state_rows(3)
    D = D.at[:, 1, :].set(Dey); E = E.at[:, 1, :].set(Eey)
    lo = lo.at[:, 1].set(-ey_ub - dey); hi = hi.at[:, 1].set(ey_ub - dey)
    soft_lo = soft_lo.at[:, 1].set(gains.qs[0])
    soft_hi = soft_hi.at[:, 1].set(gains.qs[0])

    # input box, hard (NL_Planner_Eu.py:65-66), intersected with an SQP
    # trust region around the linearisation inputs — the globalisation the
    # reference gets from IPOPT's own line search (and the C++ MPCC gets
    # from sqp_mixing, mpc.cpp:198-217); full-step SQP on the stiff tire
    # dynamics oscillates without it
    if u_trust is not None:
        lo_d = jnp.maximum(-limits.max_ls, u_bar[:, 0] - u_trust[0])
        hi_d = jnp.minimum(limits.max_rs, u_bar[:, 0] + u_trust[0])
        lo_a = jnp.maximum(-limits.max_dc, u_bar[:, 1] - u_trust[1])
        hi_a = jnp.minimum(limits.max_ac, u_bar[:, 1] + u_trust[1])
    else:
        lo_d = jnp.full((N,), -limits.max_ls)
        hi_d = jnp.full((N,), limits.max_rs)
        lo_a = jnp.full((N,), -limits.max_dc)
        hi_a = jnp.full((N,), limits.max_ac)
    D = D.at[:, 2, NX + 0].set(1.0); E = E.at[:, 2, 0].set(1.0)
    lo = lo.at[:, 2].set(lo_d.astype(dtype))
    hi = hi.at[:, 2].set(hi_d.astype(dtype))
    D = D.at[:, 3, NX + 1].set(1.0); E = E.at[:, 3, 1].set(1.0)
    lo = lo.at[:, 3].set(lo_a.astype(dtype))
    hi = hi.at[:, 3].set(hi_a.astype(dtype))

    Dx_, Ex_, ddx = next_state_rows(7)
    Dy_, Ey_, ddy = next_state_rows(8)
    if hp_opt:
        gx, gy = a_x, a_y          # plane normal instead of distance grad
    else:
        gx = g_hat[..., 0]; gy = g_hat[..., 1]
    Dds = gx[:, :, None] * Dx_[:, None, :] + gy[:, :, None] * Dy_[:, None, :]
    Eds = gx[:, :, None] * Ex_[:, None, :] + gy[:, :, None] * Ey_[:, None, :]
    dds = gx * ddx[:, None] + gy * ddy[:, None]          # (N, n_nb)
    D = D.at[:, 4:4 + n_nb, :].set(Dds.astype(dtype))
    E = E.at[:, 4:4 + n_nb, :].set(Eds.astype(dtype))
    slave = (1.0 - master_mask)[None, :]
    if hp_opt:
        # ego's own side of the (decision-variable) plane: linearised in
        # (p, dtheta, db) around (p_bar, theta_bar, b_bar):
        #   a.p + (a'.p_bar) dtheta + db  { <= -dth/2 - b_bar  (master)
        #                                 { >= +dth/2 - b_bar  (slave; its
        #   plane is the master's shipped parameter, NL_Planner_Hp.py:97,
        #   so its dtheta/db coefficients are zero }
        ap_p = (ap_x * p_bar[:, 0][:, None]
                + ap_y * p_bar[:, 1][:, None])              # a'(th).p_bar
        kidx = jnp.arange(n_nb)
        mrow = master_mask[None, :] > 0                     # (1, n_nb)
        E = E.at[:, 4 + kidx, NC + kidx].set(
            jnp.where(mrow, ap_p, 0.0).astype(dtype))
        E = E.at[:, 4 + kidx, NC + n_nb + kidx].set(
            jnp.where(mrow, 1.0, 0.0).astype(dtype))
        dth2 = jnp.asarray(limits.min_dist, dtype) / 2.0
        hi_m = (-dth2 - b_bar - dds).astype(dtype)
        lo_s = (dth2 - b_bar - dds).astype(dtype)
        hi = hi.at[:, 4:4 + n_nb].set(jnp.where(mrow, hi_m, INF))
        lo = lo.at[:, 4:4 + n_nb].set(jnp.where(mrow, -INF, lo_s))
        soft_hi = soft_hi.at[:, 4:4 + n_nb].set(
            jnp.where(mrow, gains.qs[2], INF))
        soft_lo = soft_lo.at[:, 4:4 + n_nb].set(
            jnp.where(mrow, INF, gains.qs[2]))
        # hard trust boxes on the plane perturbations; slaves' are pinned
        # to zero (their plane is a parameter)
        E = E.at[:, 4 + n_nb + kidx, NC + kidx].set(1.0)
        E = E.at[:, 4 + 2 * n_nb + kidx, NC + n_nb + kidx].set(1.0)
        tr_th = jnp.where(mrow, PLANE_TRUST_THETA, 0.0).astype(dtype)
        tr_b = jnp.where(mrow, PLANE_TRUST_B, 0.0).astype(dtype)
        lo = lo.at[:, 4 + n_nb:4 + 2 * n_nb].set(
            jnp.broadcast_to(-tr_th, (N, n_nb)))
        hi = hi.at[:, 4 + n_nb:4 + 2 * n_nb].set(
            jnp.broadcast_to(tr_th, (N, n_nb)))
        lo = lo.at[:, 4 + 2 * n_nb:].set(jnp.broadcast_to(-tr_b, (N, n_nb)))
        hi = hi.at[:, 4 + 2 * n_nb:].set(jnp.broadcast_to(tr_b, (N, n_nb)))
        return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                       soft_lo=soft_lo, soft_hi=soft_hi)
    if coupling == "hp":
        # symmetric plane rows (NL_Planner_Hp.py:89-98): each side keeps
        # dth/2 from the bisector through the midpoint. In g_hat (ego->out)
        # coordinates the bisector value at p is g_hat.(p - mid), so the
        # row g_hat.p with offset g_hat.mid bounds BOTH roles from below:
        mid = 0.5 * (p_bar[:, None, :] + neigh_xy[1:])
        bound = (limits.min_dist / 2.0
                 + jnp.sum(g_hat * mid, axis=-1) - dds)
        lo = lo.at[:, 4:].set(bound.astype(dtype))
    else:
        # slave-only linearised distance rows, soft (obs slack Qs[2],
        # NL_Planner_Eu.py:71). Disabled (lo = -inf) on master pairs.
        bound = (limits.min_dist - dist
                 + jnp.sum(g_hat * p_bar[:, None, :], axis=-1) - dds)
        lo = lo.at[:, 4:].set(
            jnp.where(slave > 0, bound.astype(dtype), -INF))
    soft_lo = soft_lo.at[:, 4:].set(gains.qs[2])

    return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                   soft_lo=soft_lo, soft_hi=soft_hi)


from colaborativempc_tpu.planners.lpv import _violations  # noqa: E402
# (identical row layout: vel, ey, 2 input rows, coupling rows 4+)


def nl_solve(track: Track, gains: Gains, limits: SysLimits,
             model: ModelParams, N: int, dt,
             x0: jnp.ndarray, x_bar: jnp.ndarray, u_bar: jnp.ndarray,
             u_old: jnp.ndarray,
             lambdas: jnp.ndarray, neigh_xy: jnp.ndarray,
             master_mask: jnp.ndarray,
             w0=None, y0=None, rho_scale0=1.0,
             sqp_iters: int = 2, sqp_mix: float = 0.7,
             u_trust=(0.06, 0.6), coupling: str = "eu", lane: int = 0,
             admm_iters: int = 100, rho: float = 10.0,
             alpha_relax: float = 1.6,
             eps: float = 1e-4,
             planes0: Optional[jnp.ndarray] = None,
             epoch_len=None, unroll=None,
             assoc: bool = False) -> NLSolution:
    """One nonlinear OCD sub-problem solve (reference PlannerEu.solve).

    SQP: linearise -> stage QP -> ADMM, ``sqp_iters`` times, with convex
    solution blending ``sqp_mix`` (the C++ MPCC sqpSolutionUpdate,
    mpc.cpp:198-217). sqp_iters=1 is RTI mode.

    For coupling="hp_opt" ``planes0`` (n_nb, N, 2) carries the incumbent
    (theta, b) planes; the master's plane is refined jointly with the
    trajectory (relinearised every SQP iteration, mixed like x/u) and the
    refined planes are returned in ``NLSolution.planes``.
    """
    dtype = x_bar.dtype
    n_nb = neigh_xy.shape[1]
    z0 = jnp.concatenate([x0, u_old]).astype(dtype)
    hp_opt = coupling == "hp_opt"
    if planes0 is None:
        planes0 = jnp.zeros((n_nb, N, 2), dtype)

    def sqp_iter(carry, _):
        x_lin, u_lin, pl, w, y, rs = carry
        qp = build_nl_qp(track, gains, limits, model, N, dt,
                         x_lin, u_lin, lambdas, neigh_xy, master_mask,
                         u_trust=u_trust, coupling=coupling, lane=lane,
                         planes0=pl)
        sol = admm_solve(qp, z0, w0=w, y0=y, rho_scale0=rs,
                         iters=admm_iters, rho=rho, alpha=alpha_relax,
                         eps=eps, epoch_len=epoch_len, unroll=unroll,
                         assoc=assoc)
        x_new = sol.z[:, :NX]
        u_new = sol.z[1:, NX:]
        x_mix = sqp_mix * x_new + (1.0 - sqp_mix) * x_lin
        u_mix = sqp_mix * u_new + (1.0 - sqp_mix) * u_lin
        if hp_opt:
            # plane perturbations are the extra control columns
            dpl = jnp.stack([sol.c[:, NC:NC + n_nb].T,
                             sol.c[:, NC + n_nb:].T], axis=-1)  # (nb, N, 2)
            pl = pl + sqp_mix * dpl * master_mask[:, None, None]
        # violations evaluated against THIS iteration's own QP (consistent
        # linearisation; avoids a whole extra build after the scan)
        viol = _violations(qp, sol.z, sol.c)
        return (x_mix, u_mix, pl, sol.w, sol.y, sol.rho_scale), (sol, viol)

    if w0 is None:
        w0 = jnp.zeros((N, 4 + (3 * n_nb if hp_opt else n_nb)), dtype)
    if y0 is None:
        y0 = jnp.zeros_like(w0)
    # per-row-class rho multipliers (scalar warm starts broadcast)
    rs0 = jnp.broadcast_to(jnp.asarray(rho_scale0, dtype), (w0.shape[1],))

    (x_fin, u_fin, pl_fin, w, y, rs), (sols, viols) = jax.lax.scan(
        sqp_iter, (x_bar, u_bar, planes0.astype(dtype), w0, y0, rs0),
        None, length=sqp_iters)

    last = jax.tree.map(lambda a: a[-1], sols)
    return NLSolution(
        x_pred=x_fin, u_pred=u_fin,
        du_pred=last.c[:, :NC], s_pred=viols[-1],
        feasible=last.feasible, w=w, y=y, rho_scale=rs,
        iterations=jnp.sum(sols.iterations), r_prim=last.r_prim,
        planes=pl_fin)
