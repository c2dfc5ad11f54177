"""Stage-structured equality-constrained QP (LQR) solves via Riccati scans.

This is the factorisation kernel of the on-device QP engine — the on-device
equivalent of the sparse direct solvers the reference calls out to (OSQP's
KKT factorisation, ``LPV_Planner.py:222-239``; HPIPM's Riccati-structured
OCP-QP solver, ``MPCC-master/C++/Interfaces/hpipm_interface.cpp``). Instead
of one big sparse matrix, the banded KKT system is solved by a backward
Riccati recursion + forward rollout, expressed as ``lax.scan`` over stages so
XLA compiles it into one fused loop; everything is batchable with ``vmap``
over agents/scenarios.

Key structure exploited by the ADMM driver (ops/admm.py): the quadratic
terms (F, G, Q, R, S) are fixed across ADMM iterations, so the expensive
backward pass that forms the gains ``K_k`` and Cholesky factors of ``Quu`` is
computed ONCE per MPC solve (``lqr_factorize``), and each ADMM iteration only
runs the cheap affine backward/forward passes (``lqr_affine_solve``) with new
linear terms — mirroring how OSQP factorises its KKT matrix once and reuses
it every iteration.

Problem (z = state, c = control, both augmented by the caller):

    min  sum_k 1/2 z_k'Q_k z_k + q_k'z_k + 1/2 c_k'R_k c_k + r_k'c_k
              + z_k'S_k c_k                      (k = 0..N-1, + terminal N)
    s.t. z_{k+1} = F_k z_k + G_k c_k + d_k,  z_0 given.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# The Riccati recursion is numerically sensitive: a float32 product at the
# default precision may run with reduced-precision inputs (TF32 on the
# H100's tensor cores), which is catastrophic for P-matrix products at long
# horizons (N=125 diverges). Every product here is pinned to full float32.
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


class LQRCost(NamedTuple):
    """Stagewise quadratic cost. Q/q have N+1 entries (terminal included)."""
    Q: jnp.ndarray   # (N+1, nz, nz)
    q: jnp.ndarray   # (N+1, nz)
    R: jnp.ndarray   # (N, nc, nc)
    r: jnp.ndarray   # (N, nc)
    S: jnp.ndarray   # (N, nz, nc) cross term


class LQRDynamics(NamedTuple):
    F: jnp.ndarray   # (N, nz, nz)
    G: jnp.ndarray   # (N, nz, nc)
    d: jnp.ndarray   # (N, nz)


class LQRFactors(NamedTuple):
    """Output of the quadratic backward pass, reused across affine solves."""
    K: jnp.ndarray         # (N, nc, nz) feedback gains
    Quu_chol: jnp.ndarray  # (N, nc, nc) Cholesky factors of Quu
    Qxu: jnp.ndarray       # (N, nz, nc)
    m: jnp.ndarray         # (N, nz)  P_{k+1} d_k
    P0: jnp.ndarray        # (nz, nz) value Hessian at k=0 (diagnostics)
    Acl: jnp.ndarray       # (N, nz, nz) closed loop F + G K (assoc path)


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def lqr_factorize(dyn: LQRDynamics, cost: LQRCost,
                  reg: float = 1e-8, unroll: int = 1) -> LQRFactors:
    """Backward Riccati pass over the quadratic terms only.

    ``unroll`` unrolls the stage scan: at long horizons the per-stage work
    (11x11 matvecs) is far smaller than the loop-step overhead, so the
    sequential sweep is latency-bound, not FLOP-bound — unrolling packs
    several stages into one loop step. Its effect on the H100 is not yet
    measured.
    """
    nz = dyn.F.shape[-1]

    def backward(P, inp):
        F, G, Q, R, S, d = inp
        PF = _mm(P, F)
        PG = _mm(P, G)
        Qxx = Q + _mm(F.T, PF)
        Quu = R + _mm(G.T, PG)
        Qxu = S + _mm(F.T, PG)
        Quu = _sym(Quu) + reg * jnp.eye(Quu.shape[-1], dtype=Quu.dtype)
        L = jnp.linalg.cholesky(Quu)
        K = -jax.scipy.linalg.cho_solve((L, True), Qxu.T)
        P_new = _sym(Qxx + _mm(Qxu, K))
        m = _mm(P, d)
        return P_new, (K, L, Qxu, m)

    P_N = cost.Q[-1]
    inputs = (dyn.F, dyn.G, cost.Q[:-1], cost.R, cost.S, dyn.d)
    P0, (K, L, Qxu, m) = jax.lax.scan(backward, P_N, inputs, reverse=True,
                                      unroll=unroll)
    Acl = dyn.F + _mm(dyn.G, K)
    return LQRFactors(K=K, Quu_chol=L, Qxu=Qxu, m=m, P0=P0, Acl=Acl)


def lqr_affine_solve(dyn: LQRDynamics, fac: LQRFactors,
                     q: jnp.ndarray, r: jnp.ndarray, z0: jnp.ndarray,
                     unroll: int = 1):
    """Solve for the optimal trajectory given (possibly new) linear terms.

    Args:
      q: (N+1, nz) linear state cost; r: (N, nc) linear control cost.
      unroll: stage-scan unroll factor (see lqr_factorize).
    Returns:
      z: (N+1, nz), c: (N, nc).
    """

    def backward(p, inp):
        F, G, K, L, Qxu, m, qk, rk = inp
        t = p + m
        Qu = rk + _mm(G.T, t)
        kff = -jax.scipy.linalg.cho_solve((L, True), Qu)
        p_new = qk + _mm(F.T, t) + _mm(Qxu, kff)
        return p_new, kff

    inputs = (dyn.F, dyn.G, fac.K, fac.Quu_chol, fac.Qxu, fac.m,
              q[:-1], r)
    _, kff = jax.lax.scan(backward, q[-1], inputs, reverse=True,
                          unroll=unroll)

    def forward(z, inp):
        F, G, d, K, kffk = inp
        c = _mm(K, z) + kffk
        z_next = _mm(F, z) + _mm(G, c) + d
        return z_next, (z, c)

    zN, (z, c) = jax.lax.scan(forward, z0,
                              (dyn.F, dyn.G, dyn.d, fac.K, kff),
                              unroll=unroll)
    z_full = jnp.concatenate([z, zN[None]], axis=0)
    return z_full, c


def _affine_scan(M: jnp.ndarray, b: jnp.ndarray, x0: jnp.ndarray,
                 reverse: bool = False, block: int | None = 8
                 ) -> jnp.ndarray:
    """All states of the affine recurrence x_{k+1} = M_k x_k + b_k via
    ``lax.associative_scan`` — log-depth instead of the N-step sequential
    scan. Returns (N+1, n) including x0 at index 0 (or x_N at the end for
    reverse=True recurrences x_k = M_k x_{k+1} + b_k, index N first).

    ``block`` selects the blocked hybrid: map composites are built
    associatively only WITHIN blocks of that many stages (so no composed
    product ever spans more than ``block`` maps) and the state is carried
    sequentially ACROSS blocks (N/block loop steps, each one batched
    matvec). Full-span composition (``block=None``) accumulates float32
    roundoff catastrophically on ill-conditioned maps — e.g. the N=125
    ADMM costate recursion under large adaptive rho loses all accuracy
    (r_prim ~ 1, measured) while short blocks match the sequential scan;
    the composite span is the conditioning knob, the cross-block carry is
    plain well-conditioned state propagation. Measured on the N=125
    Highway hard window (three agents jamming into the k=0.35 curve):
    block=16 leaves a few ADMM solves stalled above a 1e-4
    residual tolerance where block<=8 — like the sequential scan —
    converges; 8 is the default.
    """
    if reverse:
        M = M[::-1]
        b = b[::-1]
    N, n = M.shape[0], M.shape[-1]

    def combine(e1, e2):
        M1, b1 = e1
        M2, b2 = e2
        return _mm(M2, M1), jnp.einsum(
            "...ij,...j->...i", M2, b1,
            precision=jax.lax.Precision.HIGHEST) + b2

    if block is None or block >= N:
        Mc, bc = jax.lax.associative_scan(combine, (M, b))
        xs = jnp.einsum("kij,j->ki", Mc, x0,
                        precision=jax.lax.Precision.HIGHEST) + bc
    else:
        nb = -(-N // block)
        pad = nb * block - N
        if pad:
            eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), (pad, n, n))
            M = jnp.concatenate([M, eye], axis=0)
            b = jnp.concatenate([b, jnp.zeros((pad, n), b.dtype)], axis=0)
        Mb = M.reshape(nb, block, n, n)
        bb = b.reshape(nb, block, n)
        # prefix composites from each block's start (span <= block)
        Cb, db = jax.lax.associative_scan(combine, (Mb, bb), axis=1)

        def body(x, inp):
            Cj, dj = inp
            xs = jnp.einsum("kij,j->ki", Cj, x,
                            precision=jax.lax.Precision.HIGHEST) + dj
            return xs[-1], xs

        _, xs = jax.lax.scan(body, x0, (Cb, db))
        xs = xs.reshape(nb * block, n)[:N]
    out = jnp.concatenate([x0[None], xs], axis=0)
    if reverse:
        out = out[::-1]
    return out


def lqr_affine_solve_assoc(dyn: LQRDynamics, fac: LQRFactors,
                           q: jnp.ndarray, r: jnp.ndarray,
                           z0: jnp.ndarray, block: int | None = 8):
    """Parallel-in-horizon affine solve: both the costate recursion and the
    closed-loop rollout are affine recurrences in the factorised system, so
    each collapses to one associative scan (log-depth). This is the axis the
    reference never parallelises — its horizon work is strictly sequential
    (stage loops LPV_Planner.py:462-472, CasADi base_nl.py:163-304, C++
    mpc.cpp:46-52; SURVEY.md §5.7).

    Identical output to ``lqr_affine_solve`` (up to roundoff). ``block``
    bounds the composed-map span (see ``_affine_scan``): the default 8
    keeps float32 sound at N=125 under large ADMM penalties where the
    full-span composition (block=None) diverges and block=16 stalls a few
    hard solves short of tight tolerances.

    Intended for LATENCY-bound single-fleet solves at long horizons; for
    throughput-bound wide batches the sequential scan is expected to win,
    since the associative combine materialises O(N log block) nz x nz
    products through device memory. The choice was made by timings on
    another accelerator and awaits re-measurement on the H100.
    """
    # costate: p_k = Acl_k' p_{k+1} + c_k with
    # c_k = q_k + Acl_k' m_k - Qxu Quu^{-1} r_k
    AclT = jnp.swapaxes(fac.Acl, -1, -2)
    Kr = -jax.scipy.linalg.cho_solve(
        (fac.Quu_chol, True), r[..., None])[..., 0]        # Quu^{-1} r
    c = (q[:-1]
         + jnp.einsum("kij,kj->ki", AclT, fac.m,
                      precision=jax.lax.Precision.HIGHEST)
         + jnp.einsum("kij,kj->ki", fac.Qxu, Kr,
                      precision=jax.lax.Precision.HIGHEST))
    p = _affine_scan(AclT, c, q[-1], reverse=True,
                     block=block)                          # (N+1, nz)

    # feedforward from the costates
    t = p[1:] + fac.m
    Qu = r + jnp.einsum("kji,kj->ki", dyn.G, t,
                        precision=jax.lax.Precision.HIGHEST)
    kff = -jax.scipy.linalg.cho_solve((fac.Quu_chol, True),
                                      Qu[..., None])[..., 0]

    # closed-loop rollout: z_{k+1} = Acl_k z_k + (G kff_k + d_k)
    b = jnp.einsum("kij,kj->ki", dyn.G, kff,
                   precision=jax.lax.Precision.HIGHEST) + dyn.d
    z = _affine_scan(fac.Acl, b, z0, block=block)
    cctrl = (jnp.einsum("kij,kj->ki", fac.K, z[:-1],
                        precision=jax.lax.Precision.HIGHEST) + kff)
    return z, cctrl


def lqr_solve(dyn: LQRDynamics, cost: LQRCost, z0: jnp.ndarray,
              reg: float = 1e-8, assoc: bool = False):
    """One-shot equality-constrained solve (factorise + affine + rollout)."""
    fac = lqr_factorize(dyn, cost, reg)
    solve = lqr_affine_solve_assoc if assoc else lqr_affine_solve
    return solve(dyn, fac, cost.q, cost.r, z0)
