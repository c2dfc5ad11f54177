"""One ADMM refactorisation epoch as a single GPU kernel (Pallas, Triton).

The XLA epoch (ops/admm.py ``epoch_iterations_xla``) runs ``epoch_len``
iterations, each a backward and a forward Riccati sweep of N stages of
11x11 work. XLA:GPU launches several kernels per stage, so at short
horizons an epoch is thousands of tiny launches and the card mostly idles
between them (about 5,900 kernels per epoch at N=20, PERF.md).

This kernel runs the whole epoch in one launch per problem: the stage
loops are loops inside the program, the state and costate are carried in
registers, and the per-stage data stays in device memory (L2) — a block
has too little shared memory to hold a problem's stage data at long
horizons. ``vmap`` over problems adds grid axes (pallas_call's batching
rule), so a batch of B problems is one launch of B programs. The
factorisation stays in XLA; the kernel consumes its gains and the
explicit inverse of the tiny ``Quu`` (nc x nc).

Triton wants power-of-two tensor sizes, so the state, control and row
dimensions are zero-padded (11 -> 16, 2 -> 2, 6 -> 8 for the 3-agent
fleets). Padded rows are unbounded and inactive (rho 0), so they stay 0
and add nothing to the residuals. Results match the XLA epoch to float32
roundoff (tests/test_admm_kernel.py on the CPU in interpret mode; the
``reference`` phase of chip_smoke.py on the card).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

#: Warps per program: one problem per program is a (16, 16) tile at most.
NUM_WARPS = 1


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (Triton's tensor sizes)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _plain(x):
    """``x`` as the result of arithmetic. Under shard_map a value loaded from
    a kernel ref is typed as varying over the mesh axes while arithmetic on
    it is not, and a loop carry must keep its type: carries start from
    arithmetic results."""
    return x + jnp.zeros_like(x)


def _kernel(F, G, d, K, Qi, Qxu, fm, q, r, D, E, lo, hi, rv, flo, fhi,
            z0, w0, y0,
            z_out, c_out, w_out, y_out, kff_out, rp_out, rd_out,
            *, epoch_len: int, alpha: float, barrier):
    """One problem. Stage arrays carry the stage on axis 0: F (N,nz,nz),
    G (N,nz,nc), d (N,nz), K (N,nc,nz), Qi (N,nc,nc), Qxu (N,nz,nc),
    fm (N,nz), q (N+1,nz), r (N,nc), D (N,m,nz), E (N,m,nc), lo/hi/rv/
    flo/fhi/w0/y0 (N,m), z0 (1,nz). w_out/y_out double as the iterates'
    storage; kff_out carries the feedforward from the backward sweep to
    the forward one."""
    N = F.shape[0]

    def mv(A, x):           # (i, j), (j,) -> (i,)
        return jnp.sum(A * x[None, :], axis=1)

    def mv_t(A, x):         # (j, i), (j,) -> (i,)
        return jnp.sum(A * x[:, None], axis=0)

    def copy_in(k, carry):
        w_out[k] = w0[k]
        y_out[k] = y0[k]
        return carry

    jax.lax.fori_loop(0, N, copy_in, 0)
    barrier()
    zero = jnp.zeros(rp_out.shape, rp_out.dtype)

    def iteration(_, residuals):
        def backward(i, p):
            k = N - 1 - i
            t = rv[k] * (y_out[k] - w_out[k])
            t_next = p + fm[k]
            Qu = r[k] + mv_t(E[k], t) + mv_t(G[k], t_next)
            kff = -mv(Qi[k], Qu)
            kff_out[k] = kff
            return q[k] + mv_t(D[k], t) + mv_t(F[k], t_next) + mv(Qxu[k], kff)

        jax.lax.fori_loop(0, N, backward, _plain(q[N]))
        barrier()

        def forward(k, carry):
            z, r_p, r_d = carry
            c = mv(K[k], z) + kff_out[k]
            v = mv(D[k], z) + mv(E[k], c)
            w_prev = w_out[k]
            y_prev = y_out[k]
            vhat = alpha * v + (1.0 - alpha) * w_prev
            wbar = vhat + y_prev
            hik, lok = hi[k], lo[k]
            w = jnp.where(wbar > hik, hik + fhi[k] * (wbar - hik), wbar)
            w = jnp.where(wbar < lok, lok + flo[k] * (wbar - lok), w)
            active = rv[k] > 0
            r_p = jnp.maximum(r_p, jnp.where(active, jnp.abs(v - w), 0.0))
            r_d = jnp.maximum(r_d, jnp.where(active, jnp.abs(w - w_prev),
                                             0.0))
            w_out[k] = w
            y_out[k] = y_prev + vhat - w
            z_out[k] = z
            c_out[k] = c
            return mv(F[k], z) + mv(G[k], c) + d[k], r_p, r_d

        z_n, r_p, r_d = jax.lax.fori_loop(0, N, forward,
                                          (_plain(z0[0]), zero, zero))
        z_out[N] = z_n
        barrier()
        return r_p, r_d

    r_p, r_d = jax.lax.fori_loop(0, epoch_len, iteration, (zero, zero))
    rp_out[...] = r_p
    rd_out[...] = r_d


def _pad(a, shape, value=0.0):
    return jnp.pad(a, [(0, n - s) for s, n in zip(a.shape, shape)],
                   constant_values=value)


class FixedArgs(NamedTuple):
    """The kernel operands that stay fixed over a whole solve, padded to
    Triton's sizes: dynamics, constraint rows, bounds and the start state."""
    F: jnp.ndarray
    G: jnp.ndarray
    d: jnp.ndarray
    D: jnp.ndarray
    E: jnp.ndarray
    lo: jnp.ndarray
    hi: jnp.ndarray
    z0: jnp.ndarray


def pad_fixed(dyn, D, E, lo, hi, z0) -> FixedArgs:
    """Pad the solve-invariant operands (the ``EpochData`` fields of the
    same names, ops/admm.py) once, before the epoch loop; only the factors
    and the rho-dependent terms change from one epoch to the next."""
    N, m = lo.shape
    zp = next_pow2(dyn.F.shape[-1])
    cp = next_pow2(dyn.G.shape[-1])
    mp = next_pow2(m)
    return FixedArgs(
        F=_pad(dyn.F, (N, zp, zp)), G=_pad(dyn.G, (N, zp, cp)),
        d=_pad(dyn.d, (N, zp)), D=_pad(D, (N, mp, zp)),
        E=_pad(E, (N, mp, cp)), lo=_pad(lo, (N, mp), -jnp.inf),
        hi=_pad(hi, (N, mp), jnp.inf), z0=_pad(z0[None], (1, zp)))


def admm_epoch_kernel(data, z0, w, y, *, epoch_len: int, alpha: float,
                      fixed: FixedArgs | None = None,
                      interpret: bool = False):
    """``epoch_len`` ADMM iterations on one problem's fixed epoch data
    (``ops/admm.py EpochData``) in one kernel; the same contract as
    ``epoch_iterations_xla``. ``fixed`` is ``pad_fixed`` of the
    solve-invariant operands, made once per solve (padded here when
    omitted). ``interpret`` runs the
    Pallas interpreter (CPU tests)."""
    N, m = data.lo.shape
    nz = data.dyn.F.shape[-1]
    nc = data.dyn.G.shape[-1]
    zp, cp, mp = next_pow2(nz), next_pow2(nc), next_pow2(m)
    if fixed is None:
        fixed = pad_fixed(data.dyn, data.D, data.E, data.lo, data.hi, z0)
    eye = jnp.eye(nc, dtype=z0.dtype)
    Qi = jax.vmap(lambda L: jax.scipy.linalg.cho_solve((L, True), eye))(
        data.fac.Quu_chol)
    args = (
        fixed.F, fixed.G, fixed.d, _pad(data.fac.K, (N, cp, zp)),
        _pad(Qi, (N, cp, cp)), _pad(data.fac.Qxu, (N, zp, cp)),
        _pad(data.fac.m, (N, zp)), _pad(data.q, (N + 1, zp)),
        _pad(data.r, (N, cp)), fixed.D, fixed.E, fixed.lo, fixed.hi,
        _pad(data.rv, (N, mp)), _pad(data.fac_lo, (N, mp)),
        _pad(data.fac_hi, (N, mp)), fixed.z0, _pad(w, (N, mp)),
        _pad(y, (N, mp)))
    # under shard_map the outputs vary over the mesh axes the inputs do
    vma = frozenset().union(*(jax.typeof(a).vma for a in args))
    out_shape = tuple(
        jax.ShapeDtypeStruct(shape, z0.dtype, vma=vma)
        for shape in ((N + 1, zp), (N, cp), (N, mp), (N, mp), (N, cp),
                      (mp,), (mp,)))
    if interpret:
        route = dict(interpret=True)
        barrier = lambda: None  # noqa: E731 - the interpreter is sequential
    else:
        route = dict(backend="triton", compiler_params=pltr.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1))
        barrier = pltr.debug_barrier
    z, c, w, y, _, r_p, r_d = pl.pallas_call(
        partial(_kernel, epoch_len=epoch_len, alpha=alpha, barrier=barrier),
        out_shape=out_shape, name="admm_epoch", **route)(*args)
    return (z[:, :nz], c[:, :nc], w[:, :m], y[:, :m], r_p[:m], r_d[:m])
