"""The GPU ADMM epoch kernel (ops/admm_kernel.py) against the XLA epoch.

Here the kernel runs in the Pallas interpreter on the CPU; the ``chip``
test (and the ``reference`` phase of chip_smoke.py) compiles it for the
card. The XLA epoch is the reference: same iterations, same inputs.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from colaborativempc_tpu.ops import admm
from colaborativempc_tpu.ops.admm import (
    epoch_iterations_xla, use_epoch_kernel, admm_solve,
)
from colaborativempc_tpu.ops.admm_kernel import admm_epoch_kernel, next_pow2


def _epochs(data, z0, w, y, epoch_len=6, interpret=True):
    xla = epoch_iterations_xla(data, z0, w, y, epoch_len=epoch_len,
                               alpha=1.6)
    ker = admm_epoch_kernel(data, z0, w, y, epoch_len=epoch_len, alpha=1.6,
                            interpret=interpret)
    return xla, ker


def _assert_close(xla, ker, tol=chip_smoke.KERNEL_TOL):
    assert len(xla) == len(ker) == 6
    for a, b in zip(xla, ker):
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=tol)


@pytest.mark.parametrize("nz,nc,m", [(11, 2, 6), (5, 3, 3), (16, 2, 8)])
def test_kernel_matches_xla_epoch_single(nz, nc, m):
    """One problem, including padded widths (5 -> 8, 3 -> 4, 3 -> 4) and
    exact powers of two (no padding)."""
    rng = np.random.default_rng(nz * 100 + m)
    data, z0, w, y = chip_smoke.random_epoch_batch(rng, 1, 7, nz, nc, m)
    one = lambda a: a[0]  # noqa: E731
    xla, ker = _epochs(jax.tree.map(one, data), z0[0], w[0], y[0])
    _assert_close(xla, ker)


def test_kernel_matches_xla_epoch_vmapped():
    """Under vmap (pallas_call's batching rule adds a grid axis): each
    problem of the batch gets its own program."""
    rng = np.random.default_rng(3)
    data, z0, w, y = chip_smoke.random_epoch_batch(rng, 4, 9)
    xla = jax.vmap(partial(epoch_iterations_xla, epoch_len=5,
                           alpha=1.6))(data, z0, w, y)
    ker = jax.vmap(partial(admm_epoch_kernel, epoch_len=5, alpha=1.6,
                           interpret=True))(data, z0, w, y)
    _assert_close(xla, ker)


def test_kernel_vs_xla_helper_reports_agreement():
    """chip_smoke's reference comparison at a CPU-sized width."""
    err, times = chip_smoke.kernel_vs_xla(np.random.default_rng(1), 3, 6,
                                          epoch_len=4, interpret=True)
    assert err < chip_smoke.KERNEL_TOL
    assert set(times) == {"xla", "kernel"}


def test_kernel_soft_and_unbounded_rows():
    """Soft rows shrink toward the box, one-sided and fully unbounded
    (inactive) rows are carried like the XLA epoch: an inactive row
    started at zero (as admm_solve starts it) stays zero with zero
    residual."""
    rng = np.random.default_rng(9)
    data, z0, w, y = chip_smoke.random_epoch_batch(rng, 1, 6)
    data = jax.tree.map(lambda a: a[0], data)
    inactive = jnp.zeros_like(data.rv).at[:, 2].set(1.0) > 0
    data = data._replace(
        lo=jnp.where(inactive, -jnp.inf, data.lo),
        hi=jnp.where(inactive, jnp.inf, data.hi),
        rv=jnp.where(inactive, 0.0, data.rv),
        D=jnp.where(inactive[..., None], 0.0, data.D),
        E=jnp.where(inactive[..., None], 0.0, data.E))
    w0 = jnp.where(inactive, 0.0, w[0])
    y0 = jnp.where(inactive, 0.0, y[0])
    xla, ker = _epochs(data, z0[0], w0, y0)
    _assert_close(xla, ker)
    assert float(ker[4][2]) == 0.0 and float(ker[5][2]) == 0.0
    assert not np.asarray(ker[2][:, 2]).any()
    assert not np.asarray(ker[3][:, 2]).any()


def test_next_pow2():
    assert [next_pow2(n) for n in (1, 2, 3, 6, 8, 11, 16, 17)] == [
        1, 2, 4, 8, 8, 16, 16, 32]


def test_kernel_choice_rules():
    """The kernel is taken for float32 solves on the sequential recursion,
    whatever the horizon, and never for float64 or the associative scan."""
    assert use_epoch_kernel(jnp.float32, assoc=False)
    assert use_epoch_kernel(np.dtype("float32"), assoc=False)
    assert not use_epoch_kernel(jnp.float32, assoc=True)
    assert not use_epoch_kernel(jnp.float64, assoc=False)


def test_admm_solve_on_cpu_takes_xla_epoch():
    """On the CPU the kernel branch is never lowered: a float32 solve
    (kernel-eligible) compiles and equals the same solve forced onto the
    XLA epoch."""
    rng = np.random.default_rng(4)
    data, z0, _, _ = chip_smoke.random_epoch_batch(rng, 1, 8)
    from colaborativempc_tpu.ops import StageQP, LQRCost
    qp = StageQP(dyn=jax.tree.map(lambda a: a[0], data.dyn),
                 cost=LQRCost(Q=jnp.broadcast_to(jnp.eye(11), (9, 11, 11)),
                              q=data.q[0] * 0.0, R=jnp.broadcast_to(
                                  jnp.eye(2), (8, 2, 2)),
                              r=data.r[0] * 0.0,
                              S=jnp.zeros((8, 11, 2))),
                 D=data.D[0], E=data.E[0], lo=data.lo[0], hi=data.hi[0])
    a = jax.jit(lambda qp, z: admm_solve(qp, z, iters=60))(qp, z0[0])
    old = admm.use_epoch_kernel
    try:
        admm.use_epoch_kernel = lambda dtype, assoc: False
        b = jax.jit(lambda qp, z: admm_solve(qp, z, iters=60))(qp, z0[0])
    finally:
        admm.use_epoch_kernel = old
    np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))


@pytest.mark.chip
def test_kernel_matches_xla_epoch_on_gpu(gpu):
    """The kernel compiled for the card (Triton) against the XLA epoch at
    the batch cell's width (chip_smoke.py phase ``reference``)."""
    with jax.default_device(gpu):
        err, _ = chip_smoke.kernel_vs_xla(np.random.default_rng(0), 768, 20)
    assert err < chip_smoke.KERNEL_TOL, err


def _solve_both(qp, z0, route="interpret", **kw):
    """admm_solve traced with its epochs on the XLA epoch and on ``route``
    (chip_smoke.forced_epoch), under vmap over the leading axis."""
    out = []
    for name in ("xla", route):
        with chip_smoke.forced_epoch(name):
            out.append(jax.jit(jax.vmap(
                lambda qp, z0: admm_solve(qp, z0, **kw)))(qp, z0))
    return out


def _assert_solves_agree(a, b, tol=chip_smoke.ADMM_PRIMAL_TOL,
                         dual_tol=chip_smoke.ADMM_DUAL_TOL):
    np.testing.assert_array_equal(np.asarray(a.iterations),
                                  np.asarray(b.iterations))
    np.testing.assert_array_equal(np.asarray(a.feasible),
                                  np.asarray(b.feasible))
    for k in ("z", "c", "w"):
        ref = np.asarray(getattr(a, k))
        np.testing.assert_allclose(np.asarray(getattr(b, k)), ref,
                                   atol=tol * np.abs(ref).max())
    lam = [10.0 * np.asarray(s.rho_scale)[:, None, :] * np.asarray(s.y)
           for s in (a, b)]
    np.testing.assert_allclose(lam[1], lam[0],
                               atol=dual_tol * np.abs(lam[0]).max())


@pytest.mark.parametrize("B,N", [(1, 7), (4, 12)])
def test_admm_solve_through_kernel_matches_xla(B, N):
    """Whole solves (while_loop, adaptive rho rescaling, vmap) with every
    epoch in the kernel's interpreter against the XLA epoch: same
    iteration counts and feasibility, same z, c, w and multipliers."""
    qp, z0 = chip_smoke.random_stage_qp(np.random.default_rng(B + N), B, N)
    a, b = _solve_both(qp, z0, iters=400)
    _assert_solves_agree(a, b)
    assert np.asarray(a.feasible).all()
    # rho adapted away from its start: the rescale path ran
    assert float(np.abs(np.asarray(a.rho_scale) - 1.0).max()) > 0.1


def test_admm_solve_vs_xla_helper_interpret():
    """chip_smoke's admm_solve comparison (the reference phase's) with the
    kernel interpreted: within its tolerance, no count differing."""
    r = chip_smoke.admm_solve_vs_xla(np.random.default_rng(2), 3, 8,
                                     route="interpret", iters=300)
    assert max(r["per_field"][k] for k in "zcw") < chip_smoke.ADMM_PRIMAL_TOL
    assert r["per_field"]["lam"] < chip_smoke.ADMM_DUAL_TOL, r
    assert r["differing_counts"] == 0 and r["feasible"] == 1.0, r


def test_admm_solve_through_kernel_under_shard_map():
    """The kernel inside admm_solve inside shard_map (the sharded fleet
    paths): each device solves its slice of the batch; results equal the
    XLA epoch's. The Pallas interpreter does not carry shard_map's
    varying-axes types through its loops, so this runs with check_vma off;
    the compiled kernel runs with the check on in chip_smoke.py --four."""
    from jax.sharding import Mesh, PartitionSpec as P
    devices = np.array(jax.devices()[:4])
    mesh = Mesh(devices, ("scen",))
    qp, z0 = chip_smoke.random_stage_qp(np.random.default_rng(7), 4, 8)

    def sharded(qp, z0):
        f = jax.vmap(lambda qp, z0: admm_solve(qp, z0, iters=300))
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("scen"),
                                     out_specs=P("scen"),
                                     check_vma=False))(qp, z0)

    out = []
    for name in ("xla", "interpret"):
        with chip_smoke.forced_epoch(name):
            out.append(sharded(qp, z0))
    _assert_solves_agree(*out)
    assert len({s.device for s in out[1].z.addressable_shards}) == 4


def test_fleet_step_through_kernel_matches_xla():
    """One LPV fleet step (3 agents, the batch cell's solver settings)
    with the kernel interpreted against the XLA epoch."""
    from colaborativempc_tpu.config import (
        ExperimentConfig, lpv_gains, SolverConfig)
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime import (
        init_lpv_fleet, make_lpv_fleet_step)
    cfg = ExperimentConfig(n_agents=3, N=10, dt=0.02, map_type="Highway",
                           gains=lpv_gains(),
                           solver=SolverConfig(admm_iters=300))
    track = make_track(cfg.map_type)
    state = init_lpv_fleet(track, cfg)
    out = []
    for name in ("xla", "interpret"):
        with chip_smoke.forced_epoch(name):
            out.append(jax.device_get(make_lpv_fleet_step(track, cfg)(state)))
    (sa, ma), (sb, mb) = out
    np.testing.assert_array_equal(ma.iterations, mb.iterations)
    for k in ("x0", "x_pred", "u_pred"):
        np.testing.assert_allclose(getattr(sb, k), getattr(sa, k),
                                   atol=1e-4)


def test_forced_epoch_restores_routes():
    from colaborativempc_tpu.ops import admm_kernel
    saved = (admm.use_epoch_kernel, admm_kernel.admm_epoch_kernel,
             jax.lax.platform_dependent)
    for route in ("xla", "interpret", "kernel"):
        with chip_smoke.forced_epoch(route):
            pass
    with pytest.raises(ValueError):
        with chip_smoke.forced_epoch("unknown"):
            pass
    assert (admm.use_epoch_kernel, admm_kernel.admm_epoch_kernel,
            jax.lax.platform_dependent) == saved


def test_kernel_pads_fixed_operands_once():
    """Inside admm_solve the solve-invariant operands (dynamics, rows,
    bounds, start state) are padded before the epoch loop: the while
    body holds only the per-epoch pads."""
    qp, z0 = chip_smoke.random_stage_qp(np.random.default_rng(0), 1, 6)
    one = jax.tree.map(lambda a: a[0], (qp, z0))

    def count_pads(jaxpr, inside):
        n_in = n_out = 0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pad":
                if inside:
                    n_in += 1
                else:
                    n_out += 1
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    j = getattr(sub, "jaxpr", None)
                    if j is not None:
                        a, b = count_pads(getattr(j, "jaxpr", j), inside
                                          or eqn.primitive.name == "while")
                        n_in, n_out = n_in + a, n_out + b
        return n_in, n_out

    with chip_smoke.forced_epoch("interpret"):
        jaxpr = jax.make_jaxpr(lambda qp, z0: admm_solve(qp, z0, iters=60))(
            *one)
    inside, outside = count_pads(jaxpr.jaxpr, False)
    assert outside == 8, outside      # F, G, d, D, E, lo, hi, z0
    assert inside == 11, inside       # K, Qi, Qxu, m, q, r, rv, fac_lo,
    #                                   fac_hi, w, y


@pytest.mark.chip
def test_admm_solve_through_kernel_on_gpu(gpu):
    """Whole solves with the compiled kernel against the XLA epoch at the
    batch cell's width (chip_smoke.py phase ``reference``)."""
    with jax.default_device(gpu):
        r = chip_smoke.admm_solve_vs_xla(np.random.default_rng(0), 768, 20)
    assert max(r["per_field"][k] for k in "zcw") < chip_smoke.ADMM_PRIMAL_TOL
    assert r["per_field"]["lam"] < chip_smoke.ADMM_DUAL_TOL, r
    assert r["differing_counts"] <= 768 // 20, r
    assert r["feasible"] == r["feasible_xla"], r
