"""Inequality-constrained stage QP via ADMM with Riccati inner solves.

The on-device replacement for OSQP (reference ``LPV_Planner.py:192-249``):
an operator-splitting QP solver whose linear-system step exploits the MPC
banded structure through the Riccati factorisation in ops/lqr.py instead of a
sparse LDL^T. Everything is jittable with static shapes, runs a bounded
iteration count (``lax.while_loop`` over refactorisation epochs with
residual-based early exit), and vmaps over agents/scenario batches — the
batch dimension is what fills the device. On a GPU each epoch's
iterations on the sequential recursion run as one kernel
(ops/admm_kernel.py).

Problem:

    min   sum_k stage_cost(z_k, c_k)        (LQRCost quadratics)
    s.t.  z_{k+1} = F_k z_k + G_k c_k + d_k,   z_0 fixed
          lo_k <= D_k z_k + E_k c_k <= hi_k    (per-stage, stage-local)

Bounds may be HARD or SOFT: a soft bound with weight sigma adds
sigma * violation^2 to the objective — the analytic elimination of a
quadratically-penalised slack variable on a single row (the reference's
slack formulation, LPV_Planner.py:294-303). Keeping 1e7-scale slack weights
out of the Riccati matrices preserves float32 conditioning; the
weight only appears in the closed-form prox shrinkage of the w-step.

Splitting:  v = Dz + Ec,  min J(z,c) + g(w)  s.t. v = w,  where g is the
box indicator (hard rows) plus the quadratic violation penalty (soft rows).

Per iteration (scaled dual y, over-relaxation alpha):
    (z, c) <- argmin J + rho/2 || Dz + Ec - w + y ||^2      (Riccati solve)
    v      <- Dz + Ec;   vhat <- alpha v + (1-alpha) w
    w      <- prox_g(vhat + y)          (clip / shrink toward the box)
    y      <- y + vhat - w

Adaptive rho (OSQP-style): every ``epoch_len`` iterations rho is rescaled by
sqrt(r_prim/r_dual) (bounded) and the Riccati factorisation is redone. This
is essential for rows with little single-stage control authority (e.g.
position constraints one Euler step ahead) pressed by stiff penalties: with
fixed rho the scaled dual needs O(sigma/rho) iterations to ramp; adaptive
rho closes the gap geometrically. Within an epoch the factorisation is
reused, keeping OSQP's factor-once/iterate-cheap economics.

The adaptive scale is PER ROW CLASS (one multiplier per constraint row m,
shared across stages — matching OSQP's per-constraint rho vector): stiff
soft rows (hyperplane/distance penalties) and plain box rows (inputs) need
rho values orders of magnitude apart; a single scalar compromise was
measured to leave a few-percent tail of warm long-horizon solves
(N=125 fleet steps) above tolerance at a 600-iteration budget. The
warm-startable ``rho_scale`` is therefore shape (m,); scalar inputs
broadcast.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from functools import partial

_es = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

from colaborativempc_tpu.ops.lqr import (
    LQRCost, LQRDynamics, LQRFactors, lqr_factorize, lqr_affine_solve,
    lqr_affine_solve_assoc,
)


class StageQP(NamedTuple):
    """A stage-structured QP: LQR data + per-stage inequality rows.

    ``soft_lo``/``soft_hi``: optional per-row quadratic penalty weights;
    +inf (or None) means a hard bound.
    """
    dyn: LQRDynamics
    cost: LQRCost
    D: jnp.ndarray    # (N, m, nz)
    E: jnp.ndarray    # (N, m, nc)
    lo: jnp.ndarray   # (N, m)
    hi: jnp.ndarray   # (N, m)
    soft_lo: Optional[jnp.ndarray] = None   # (N, m) weights or None
    soft_hi: Optional[jnp.ndarray] = None


class ADMMSolution(NamedTuple):
    z: jnp.ndarray
    c: jnp.ndarray
    w: jnp.ndarray
    y: jnp.ndarray
    rho_scale: jnp.ndarray  # (m,) per-row-class rho multipliers (warm-startable)
    iterations: jnp.ndarray
    r_prim: jnp.ndarray
    r_dual: jnp.ndarray
    feasible: jnp.ndarray   # primal residual below tolerance at exit


class _EpochState(NamedTuple):
    z: jnp.ndarray
    c: jnp.ndarray
    w: jnp.ndarray
    y: jnp.ndarray
    rho_scale: jnp.ndarray
    it: jnp.ndarray
    r_prim: jnp.ndarray
    r_dual: jnp.ndarray


def _active_rows(qp: StageQP) -> jnp.ndarray:
    """Mask of rows with at least one finite bound; fully unbounded rows are
    excluded from the splitting so they add no proximal damping."""
    return (jnp.isfinite(qp.lo) | jnp.isfinite(qp.hi)).astype(qp.D.dtype)


def _rho_vec(qp: StageQP, rho) -> jnp.ndarray:
    """Broadcast rho to per-row shape (N, m)."""
    return jnp.broadcast_to(jnp.asarray(rho, qp.lo.dtype), qp.lo.shape)


def build_admm_cost(qp: StageQP, rho) -> LQRCost:
    """Quadratic cost augmented with the rho-penalty terms."""
    mask = _active_rows(qp)
    rv = _rho_vec(qp, rho) * mask
    D = qp.D * mask[..., None]
    E = qp.E * mask[..., None]
    DtD = _es("km,kmi,kmj->kij", rv, D, D)
    EtE = _es("km,kmi,kmj->kij", rv, E, E)
    DtE = _es("km,kmi,kmj->kij", rv, D, E)
    Q = qp.cost.Q.at[:-1].add(DtD)
    R = qp.cost.R + EtE
    S = qp.cost.S + DtE
    return LQRCost(Q=Q, q=qp.cost.q, R=R, r=qp.cost.r, S=S)


class EpochData(NamedTuple):
    """What one refactorisation epoch holds fixed: the factorised
    rho-augmented system and the (masked) constraint rows. Both epoch
    implementations (:func:`epoch_iterations_xla` and the GPU kernel,
    ops/admm_kernel.py) run the same iterations on it."""
    dyn: LQRDynamics
    fac: LQRFactors
    q: jnp.ndarray        # (N+1, nz) rho-augmented linear state cost
    r: jnp.ndarray        # (N, nc)
    D: jnp.ndarray        # (N, m, nz) rows, zeroed where inactive
    E: jnp.ndarray        # (N, m, nc)
    lo: jnp.ndarray       # (N, m)
    hi: jnp.ndarray       # (N, m)
    rv: jnp.ndarray       # (N, m) effective rho, 0 on inactive rows
    fac_lo: jnp.ndarray   # (N, m) soft-row prox shrink factors (0 = hard)
    fac_hi: jnp.ndarray   # (N, m)


def epoch_iterations_xla(data: EpochData, z0, w, y, *, epoch_len: int,
                         alpha: float, affine=lqr_affine_solve):
    """``epoch_len`` ADMM iterations on fixed epoch data, as a ``lax.scan``
    over iterations around the Riccati affine solve ``affine``.

    Returns (z, c) of the last iteration, the final (w, y), and the last
    iteration's per-row-class residuals (r_prim, r_dual), shape (m,).
    """
    active = (data.rv > 0).astype(data.rv.dtype)

    def prox(wbar):
        w = jnp.where(wbar > data.hi,
                      data.hi + data.fac_hi * (wbar - data.hi), wbar)
        return jnp.where(wbar < data.lo,
                         data.lo + data.fac_lo * (wbar - data.lo), w)

    def iteration(carry, _):
        w_prev, y_prev, _, _ = carry
        t = data.rv * (y_prev - w_prev)
        q = data.q.at[:-1].add(_es("kmi,km->ki", data.D, t))
        r = data.r + _es("kmi,km->ki", data.E, t)
        z, c = affine(data.dyn, data.fac, q, r, z0)
        v = _es("kmi,ki->km", data.D, z[:-1]) + _es("kmi,ki->km", data.E, c)
        vhat = alpha * v + (1.0 - alpha) * w_prev
        w = prox(vhat + y_prev)
        y = y_prev + vhat - w
        # residuals per ROW CLASS (max over stages): each class drives
        # its own rho multiplier
        r_p = jnp.max(jnp.abs(active * (v - w)), axis=0)
        r_d = jnp.max(jnp.abs(active * (w - w_prev)), axis=0)
        return (w, y, r_p, r_d), (z, c)

    # derive the residual carry init from data so its varying-axes type
    # matches the loop outputs under shard_map (scan-vma typing)
    zerov = jnp.sum(w, axis=0) * 0.0          # (m,)
    (w, y, r_p, r_d), zc = jax.lax.scan(
        iteration, (w, y, zerov, zerov), None, length=epoch_len)
    return zc[0][-1], zc[1][-1], w, y, r_p, r_d


def use_epoch_kernel(dtype, assoc: bool) -> bool:
    """Whether ``admm_solve`` runs its epochs as the GPU kernel
    (ops/admm_kernel.py) when it runs on a GPU: every float32 solve on the
    sequential Riccati recursion, which the kernel implements. Measured on
    one H100 it beat the XLA epoch at N=20 with 3 and 768 problems
    (PERF.md). The associative scan stays on XLA: at N=125 the sequential
    recursion needs about 2.5x its ADMM iterations over a 150-step course
    in float32, which outweighs the faster epochs."""
    return not assoc and jnp.dtype(dtype) == jnp.dtype(jnp.float32)


def scale_stage_qp(qp: StageQP, tz: jnp.ndarray, tc: jnp.ndarray) -> StageQP:
    """Diagonal variable scaling of a stage QP: z = diag(tz) z~, c = diag(tc) c~.

    The on-device counterpart of the reference MPCC's per-iteration
    state/input normalisation (``MPCC-master/C++/Params/params.h:31-58``
    NormalizationParam T_x/T_u; applied at ``MPC/mpc.cpp:91-132``
    normalizeDynamics/normalizeCost/normalizeCon): solving in the scaled
    variables keeps the Riccati/ADMM matrices O(1)-conditioned when raw
    magnitudes span orders of magnitude (1:43-scale cars: I=2.78e-5 vs
    positions ~1e1). Because the scaling is a pure change of variables,
    constraint VALUES v = D z + E c are invariant — so ADMM's (w, y,
    rho_scale) warm starts, residuals and the feasibility tolerance keep
    their meaning across scaled/unscaled solves. De-normalise a solution
    with ``z = z~ * tz``, ``c = c~ * tc`` (``mpc.cpp deNormalizeSolution``).
    """
    tz = jnp.asarray(tz, qp.lo.dtype)
    tc = jnp.asarray(tc, qp.lo.dtype)
    tzi = 1.0 / tz
    dyn = LQRDynamics(
        F=tzi[None, :, None] * qp.dyn.F * tz[None, None, :],
        G=tzi[None, :, None] * qp.dyn.G * tc[None, None, :],
        d=qp.dyn.d * tzi[None, :])
    cost = LQRCost(
        Q=tz[None, :, None] * qp.cost.Q * tz[None, None, :],
        q=qp.cost.q * tz[None, :],
        R=tc[None, :, None] * qp.cost.R * tc[None, None, :],
        r=qp.cost.r * tc[None, :],
        S=tz[None, :, None] * qp.cost.S * tc[None, None, :])
    return qp._replace(dyn=dyn, cost=cost,
                       D=qp.D * tz[None, None, :],
                       E=qp.E * tc[None, None, :])


def admm_solve(qp: StageQP, z0: jnp.ndarray,
               w0: Optional[jnp.ndarray] = None,
               y0: Optional[jnp.ndarray] = None,
               iters: int = 100, rho: float = 10.0, alpha: float = 1.6,
               eps: float = 1e-4, reg: float = 1e-8,
               epoch_len: Optional[int] = None,
               rho_scale0: float = 1.0,
               max_rho_scale: float = 1e6,
               feas_tol: float = 1e-2,
               assoc: bool = False,
               unroll: Optional[int] = None) -> ADMMSolution:
    """Solve the stage QP with warm-startable (w0, y0, rho_scale0).

    On a GPU every float32 epoch on the sequential recursion runs as one
    kernel launch per problem (ops/admm_kernel.py); ``unroll`` then shapes
    only the factorisation. The XLA epoch runs on other platforms, for
    float64 and for ``assoc``.

    ``assoc`` switches the inner affine solves to the parallel-in-horizon
    associative-scan path (log-depth; pays ~3x FLOPs) — meant for long
    horizons / small batches where the sequential scan is latency-bound.

    ``unroll`` unrolls the sequential Riccati stage scans (ops/lqr.py):
    at long horizons the per-stage matvecs are smaller than the scan-step
    overhead, so unrolling packs several stages per loop step. Default:
    auto (8 beyond N=96, 4 beyond N=48, else 1). The multi-agent LPV
    fleet step overrides with a full unroll at N<=24 (runtime/simulate.py).

    ``epoch_len`` default is N-dependent (10/20/30 by horizon): each
    epoch pays one Riccati refactorisation whose cost grows with N, and a
    batch's wall time is set by its slowest problem, so long horizons
    amortise the factorisation over more iterations; very short horizons
    keep the fast rho adaptation of frequent refactorisation. Note
    ``iters`` rounds DOWN to whole epochs (``iters // epoch_len``), so e.g.
    ``iters=100`` with the N>=48 default of 30 caps at 90 iterations and
    rho adapts per 30; budget-sensitive callers should pin ``epoch_len``
    explicitly.

    The unroll ladder and the epoch lengths were chosen by timings on
    another accelerator; they await re-measurement on the H100.
    """
    N, m = qp.lo.shape
    if unroll is None:
        unroll = 8 if N >= 96 else (4 if N >= 48 else 1)
    if epoch_len is None:
        epoch_len = 10 if N < 16 else (20 if N < 48 else 30)
    if assoc:
        affine = lqr_affine_solve_assoc
    else:
        affine = partial(lqr_affine_solve, unroll=unroll)
    dtype = z0.dtype

    if w0 is None:
        w0 = jnp.clip(jnp.zeros((N, m), dtype), qp.lo, qp.hi)
    if y0 is None:
        y0 = jnp.zeros((N, m), dtype)

    mask = _active_rows(qp)
    base_rv = _rho_vec(qp, rho) * mask
    Dm = qp.D * mask[..., None]
    Em = qp.E * mask[..., None]

    slo = (jnp.full_like(qp.lo, jnp.inf) if qp.soft_lo is None
           else qp.soft_lo.astype(dtype))
    shi = (jnp.full_like(qp.hi, jnp.inf) if qp.soft_hi is None
           else qp.soft_hi.astype(dtype))

    # iters rounds DOWN to whole epochs so the stated budget is a hard cap
    n_epochs = max(1, iters // epoch_len)

    kernel = use_epoch_kernel(dtype, assoc)
    if kernel:
        from colaborativempc_tpu.ops.admm_kernel import (
            admm_epoch_kernel, pad_fixed)
        # the kernel's solve-invariant operands, padded once for all epochs
        fixed = pad_fixed(qp.dyn, Dm, Em, qp.lo, qp.hi, z0)

    def rho_rescale(state, z, c, w, y, r_prim, r_dual):
        # OSQP-style per-class rescale, bounded; rescale the scaled dual
        # accordingly. Classes already inside tolerance keep their rho
        # (rebalancing a converged class would only perturb it).
        ratio = jnp.sqrt(r_prim / jnp.maximum(r_dual, 1e-12))
        ratio = jnp.clip(ratio, 0.2, 10.0)
        new_scale = jnp.clip(state.rho_scale * ratio, 1e-3, max_rho_scale)
        quiet = (r_prim < eps) & (r_dual < eps)
        new_scale = jnp.where(quiet, state.rho_scale, new_scale)
        y = y * (state.rho_scale / new_scale)[None, :]
        return _EpochState(z=z, c=c, w=w, y=y, rho_scale=new_scale,
                           it=state.it + epoch_len,
                           r_prim=r_prim, r_dual=r_dual)

    def epoch(state: _EpochState) -> _EpochState:
        rv = base_rv * state.rho_scale[None, :]
        aug_cost = build_admm_cost(qp, rv)
        fac = lqr_factorize(qp.dyn, aug_cost, reg, unroll=unroll)
        rv_safe = jnp.where(rv > 0, rv, 1.0)
        data = EpochData(
            dyn=qp.dyn, fac=fac, q=aug_cost.q, r=aug_cost.r, D=Dm, E=Em,
            lo=qp.lo, hi=qp.hi, rv=rv,
            fac_lo=jnp.where(jnp.isinf(slo), 0.0,
                             rv_safe / (rv_safe + 2.0 * slo)),
            fac_hi=jnp.where(jnp.isinf(shi), 0.0,
                             rv_safe / (rv_safe + 2.0 * shi)))
        xla = partial(epoch_iterations_xla, epoch_len=epoch_len,
                      alpha=alpha, affine=affine)
        if kernel:
            out = jax.lax.platform_dependent(
                data, z0, state.w, state.y, fixed,
                cuda=lambda *a: admm_epoch_kernel(
                    *a[:4], epoch_len=epoch_len, alpha=alpha, fixed=a[4]),
                default=lambda *a: xla(*a[:4]))
        else:
            out = xla(data, z0, state.w, state.y)
        return rho_rescale(state, *out)

    def cond(state: _EpochState):
        not_conv = ((jnp.max(state.r_prim) > eps)
                    | (jnp.max(state.r_dual) > eps))
        return (state.it < n_epochs * epoch_len) & not_conv

    nz = qp.dyn.F.shape[-1]
    nc = qp.dyn.G.shape[-1]
    # tie the inits to the data so their varying-axes types match the loop
    # outputs under shard_map
    tie = jnp.sum(w0) * 0.0 + jnp.sum(z0) * 0.0
    big = jnp.full((m,), jnp.inf, dtype) + tie
    init = _EpochState(
        z=jnp.zeros((N + 1, nz), dtype) + tie,
        c=jnp.zeros((N, nc), dtype) + tie,
        w=w0 + tie, y=y0 + tie,
        rho_scale=(jnp.broadcast_to(jnp.asarray(rho_scale0, dtype), (m,))
                   + tie),
        it=jnp.asarray(0), r_prim=big, r_dual=big)

    out = jax.lax.while_loop(cond, epoch, init)
    r_prim = jnp.max(out.r_prim)
    return ADMMSolution(z=out.z, c=out.c, w=out.w, y=out.y,
                        rho_scale=out.rho_scale,
                        iterations=out.it, r_prim=r_prim,
                        r_dual=jnp.max(out.r_dual),
                        # tolerant acceptance mirroring the reference, which
                        # treats OSQP 'solved_inaccurate' and even
                        # 'max_iter_reached' as usable (LPV_Planner.py:241-249)
                        feasible=r_prim < feas_tol)
