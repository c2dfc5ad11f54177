"""QP engine tests: Riccati LQR vs dense KKT, ADMM vs SLSQP.

The analytic ground-truth strategy mirrors the reference's native solver
tests (MPCC-master/C++/Tests): small random problems checked against an
independent dense solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

from colaborativempc_tpu.ops import (
    LQRCost, LQRDynamics, StageQP, lqr_solve, admm_solve,
)
from colaborativempc_tpu.ops.reference import dense_kkt_solve as dense_solve


def random_problem(rng, N=8, nz=4, nc=2, with_cross=True):
    F = rng.normal(size=(N, nz, nz)) * 0.3 + np.eye(nz) * 0.9
    G = rng.normal(size=(N, nz, nc)) * 0.5
    d = rng.normal(size=(N, nz)) * 0.1

    def spd(n, scale):
        A = rng.normal(size=(n, n))
        return A @ A.T * scale + np.eye(n)

    Q = np.stack([spd(nz, 0.1) for _ in range(N + 1)])
    R = np.stack([spd(nc, 0.1) for _ in range(N)])
    S = (rng.normal(size=(N, nz, nc)) * 0.05) if with_cross else np.zeros((N, nz, nc))
    q = rng.normal(size=(N + 1, nz)) * 0.5
    r = rng.normal(size=(N, nc)) * 0.5
    z0 = rng.normal(size=nz)
    return F, G, d, Q, R, S, q, r, z0


def test_lqr_matches_dense_kkt():
    rng = np.random.default_rng(0)
    F, G, d, Q, R, S, q, r, z0 = random_problem(rng)
    z_ref, c_ref = dense_solve(F, G, d, Q, R, S, q, r, z0)

    with jax.enable_x64():
        dyn = LQRDynamics(*[jnp.asarray(a, jnp.float64) for a in (F, G, d)])
        cost = LQRCost(*[jnp.asarray(a, jnp.float64) for a in (Q, q, R, r, S)])
        z, c = lqr_solve(dyn, cost, jnp.asarray(z0, jnp.float64))
        z, c = np.asarray(z), np.asarray(c)
    assert np.allclose(z, z_ref, atol=1e-8)
    assert np.allclose(c, c_ref, atol=1e-8)


def test_lqr_float32_accuracy():
    rng = np.random.default_rng(1)
    F, G, d, Q, R, S, q, r, z0 = random_problem(rng, N=20)
    z_ref, c_ref = dense_solve(F, G, d, Q, R, S, q, r, z0)
    dyn = LQRDynamics(*[jnp.asarray(a, jnp.float32) for a in (F, G, d)])
    cost = LQRCost(*[jnp.asarray(a, jnp.float32) for a in (Q, q, R, r, S)])
    z, c = lqr_solve(dyn, cost, jnp.asarray(z0, jnp.float32))
    assert np.allclose(np.asarray(z), z_ref, atol=2e-3)
    assert np.allclose(np.asarray(c), c_ref, atol=2e-3)


def _constrained_problem(rng, N=6, nz=3, nc=2, m=3):
    """Random stage QP with guaranteed-feasible bounds (a band around a
    random rolled-out trajectory), some of which cut into the solution."""
    F, G, d, Q, R, S, q, r, z0 = random_problem(rng, N=N, nz=nz, nc=nc)
    D = rng.normal(size=(N, m, nz)) * 0.5
    E = rng.normal(size=(N, m, nc)) * 0.5
    ctil = rng.normal(size=(N, nc)) * 0.3
    zs = [z0]
    for k in range(N):
        zs.append(F[k] @ zs[-1] + G[k] @ ctil[k] + d[k])
    zs = np.array(zs)
    vt = (np.einsum("kmi,ki->km", D, zs[:-1])
          + np.einsum("kmi,ki->km", E, ctil))
    lo = vt - rng.uniform(0.05, 0.5, size=(N, m))
    hi = vt + rng.uniform(0.05, 0.5, size=(N, m))
    return F, G, d, Q, R, S, q, r, z0, D, E, lo, hi


def _reference_qp_solve(F, G, d, Q, R, S, q, r, z0, D, E, lo, hi):
    """Independent reference solve: eliminate states by rollout (the problem
    is then a dense QP in the stacked controls), extract exact quadratic
    matrices by basis evaluation, solve with scipy trust-constr."""
    N, nz, nc = F.shape[0], F.shape[1], G.shape[2]
    nv = N * nc

    def rollout(cvec):
        cs = cvec.reshape(N, nc)
        zs = [z0]
        for k in range(N):
            zs.append(F[k] @ zs[-1] + G[k] @ cs[k] + d[k])
        return np.array(zs), cs

    def objective(cvec):
        zs, cs = rollout(cvec)
        val = 0.0
        for k in range(1, N + 1):
            val += 0.5 * zs[k] @ Q[k] @ zs[k] + q[k] @ zs[k]
        for k in range(N):
            val += 0.5 * cs[k] @ R[k] @ cs[k] + r[k] @ cs[k]
            val += zs[k] @ S[k] @ cs[k]
        return val

    def cons_vals(cvec):
        zs, cs = rollout(cvec)
        return (np.einsum("kmi,ki->km", D, zs[:-1])
                + np.einsum("kmi,ki->km", E, cs)).ravel()

    # exact quadratic extraction (objective is quadratic, constraints affine)
    f0 = objective(np.zeros(nv))
    eye = np.eye(nv)
    fs = np.array([objective(eye[i]) for i in range(nv)])
    fsm = np.array([objective(-eye[i]) for i in range(nv)])
    g = (fs - fsm) / 2.0
    H = np.empty((nv, nv))
    for i in range(nv):
        for j in range(nv):
            H[i, j] = (objective(eye[i] + eye[j]) - fs[i] - fs[j] + f0)
    v0 = cons_vals(np.zeros(nv))
    Ac = np.column_stack([cons_vals(eye[i]) - v0 for i in range(nv)])

    res = scipy.optimize.minimize(
        lambda c: 0.5 * c @ H @ c + g @ c,
        np.zeros(nv), jac=lambda c: H @ c + g,
        method="trust-constr",
        constraints=[scipy.optimize.LinearConstraint(
            Ac, lo.ravel() - v0, hi.ravel() - v0)],
        options={"gtol": 1e-12, "xtol": 1e-14, "maxiter": 3000})
    zs, cs = rollout(res.x)
    return zs, cs, res.fun + f0


def test_admm_matches_slsqp():
    rng = np.random.default_rng(2)
    F, G, d, Q, R, S, q, r, z0, D, E, lo, hi = _constrained_problem(rng)
    z_ref, c_ref, f_ref = _reference_qp_solve(F, G, d, Q, R, S, q, r, z0, D, E, lo, hi)

    with jax.enable_x64():
        qp = StageQP(
            dyn=LQRDynamics(*[jnp.asarray(a, jnp.float64) for a in (F, G, d)]),
            cost=LQRCost(*[jnp.asarray(a, jnp.float64) for a in (Q, q, R, r, S)]),
            D=jnp.asarray(D, jnp.float64), E=jnp.asarray(E, jnp.float64),
            lo=jnp.asarray(lo, jnp.float64), hi=jnp.asarray(hi, jnp.float64))
        sol = admm_solve(qp, jnp.asarray(z0, jnp.float64),
                         iters=2000, rho=5.0, eps=1e-9)
        r_prim = float(sol.r_prim)
        z_sol, c_sol = np.asarray(sol.z), np.asarray(sol.c)
    assert r_prim < 1e-7
    assert np.allclose(z_sol, z_ref, atol=1e-4)
    assert np.allclose(c_sol, c_ref, atol=1e-4)


def test_admm_unconstrained_equals_lqr():
    """With infinite bounds ADMM must reproduce the pure LQR solution."""
    rng = np.random.default_rng(3)
    F, G, d, Q, R, S, q, r, z0 = random_problem(rng, N=6, nz=3, nc=2)
    m = 2
    D = rng.normal(size=(6, m, 3))
    E = rng.normal(size=(6, m, 2))
    lo = np.full((6, m), -np.inf)
    hi = np.full((6, m), np.inf)
    dyn = LQRDynamics(*[jnp.asarray(a, jnp.float32) for a in (F, G, d)])
    cost = LQRCost(*[jnp.asarray(a, jnp.float32) for a in (Q, q, R, r, S)])
    z_lqr, c_lqr = lqr_solve(dyn, cost, jnp.asarray(z0, jnp.float32))
    qp = StageQP(dyn=dyn, cost=cost,
                 D=jnp.asarray(D, jnp.float32), E=jnp.asarray(E, jnp.float32),
                 lo=jnp.asarray(lo, jnp.float32), hi=jnp.asarray(hi, jnp.float32))
    sol = admm_solve(qp, jnp.asarray(z0, jnp.float32), iters=200, eps=1e-6)
    assert np.allclose(np.asarray(sol.z), np.asarray(z_lqr), atol=1e-3)


def test_admm_active_constraints_respected():
    """Tight box on the first control must be respected at the solution."""
    rng = np.random.default_rng(4)
    F, G, d, Q, R, S, q, r, z0 = random_problem(rng, N=5, nz=3, nc=2)
    r = r - 2.0  # push controls positive
    N, nc = 5, 2
    D = np.zeros((N, nc, 3))
    E = np.stack([np.eye(nc)] * N)
    lo = np.full((N, nc), -0.05)
    hi = np.full((N, nc), 0.05)
    qp = StageQP(
        dyn=LQRDynamics(*[jnp.asarray(a, jnp.float32) for a in (F, G, d)]),
        cost=LQRCost(*[jnp.asarray(a, jnp.float32) for a in (Q, q, R, r, S)]),
        D=jnp.asarray(D, jnp.float32), E=jnp.asarray(E, jnp.float32),
        lo=jnp.asarray(lo, jnp.float32), hi=jnp.asarray(hi, jnp.float32))
    sol = admm_solve(qp, jnp.asarray(z0, jnp.float32), iters=300, eps=1e-6)
    c = np.asarray(sol.c)
    assert (c <= 0.05 + 1e-3).all() and (c >= -0.05 - 1e-3).all()
    # the cost push means the upper bound is active somewhere
    assert (c > 0.045).any()


def test_admm_vmap_batch():
    """Batched solves via vmap agree with individual solves."""
    rng = np.random.default_rng(5)
    probs = [_constrained_problem(rng, N=5) for _ in range(3)]

    def to_qp(p):
        F, G, d, Q, R, S, q, r, z0, D, E, lo, hi = p
        return StageQP(
            dyn=LQRDynamics(*[jnp.asarray(a, jnp.float32) for a in (F, G, d)]),
            cost=LQRCost(*[jnp.asarray(a, jnp.float32) for a in (Q, q, R, r, S)]),
            D=jnp.asarray(D, jnp.float32), E=jnp.asarray(E, jnp.float32),
            lo=jnp.asarray(lo, jnp.float32), hi=jnp.asarray(hi, jnp.float32))

    qps = [to_qp(p) for p in probs]
    z0s = [jnp.asarray(p[8], jnp.float32) for p in probs]
    batched_qp = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    batched_z0 = jnp.stack(z0s)

    # epoch_len pinned: one of the random problems does not converge within
    # the budget, and an unconverged iterate depends on the epoch schedule
    # (the N-dependent default is tuned for MPC-structured problems)
    solve = jax.vmap(lambda qp, z0: admm_solve(qp, z0, iters=300, eps=1e-6,
                                               epoch_len=25))
    bsol = solve(batched_qp, batched_z0)
    for i, (qp, z0) in enumerate(zip(qps, z0s)):
        sol = admm_solve(qp, z0, iters=300, eps=1e-6, epoch_len=25)
        assert np.allclose(np.asarray(bsol.z[i]), np.asarray(sol.z), atol=2e-3)


def test_assoc_affine_matches_sequential():
    """The parallel-in-horizon associative-scan solve must equal the
    sequential Riccati affine solve."""
    from colaborativempc_tpu.ops.lqr import (
        lqr_factorize, lqr_affine_solve, lqr_affine_solve_assoc,
    )
    rng = np.random.default_rng(7)
    F, G, d, Q, R, S, q, r, z0 = random_problem(rng, N=40, nz=6, nc=3)
    dyn = LQRDynamics(*[jnp.asarray(a, jnp.float32) for a in (F, G, d)])
    cost = LQRCost(*[jnp.asarray(a, jnp.float32) for a in (Q, q, R, r, S)])
    fac = lqr_factorize(dyn, cost)
    z1, c1 = lqr_affine_solve(dyn, fac, cost.q, cost.r,
                              jnp.asarray(z0, jnp.float32))
    z2, c2 = lqr_affine_solve_assoc(dyn, fac, cost.q, cost.r,
                                    jnp.asarray(z0, jnp.float32))
    assert np.allclose(np.asarray(z1), np.asarray(z2), atol=2e-3), (
        np.abs(np.asarray(z1) - np.asarray(z2)).max())
    assert np.allclose(np.asarray(c1), np.asarray(c2), atol=2e-3)


def test_blocked_affine_scan_matches_sequential():
    """The blocked-hybrid associative scan (composites bounded to `block`
    stages, state carried sequentially across blocks) is exact for every
    block size, including non-divisors of N and block >= N (full span),
    in both scan directions."""
    from colaborativempc_tpu.ops.lqr import _affine_scan
    rng = np.random.default_rng(11)
    N, n = 57, 7
    M = jnp.asarray(0.4 * rng.standard_normal((N, n, n)))
    b = jnp.asarray(rng.standard_normal((N, n)))
    x0 = jnp.asarray(rng.standard_normal(n))

    def seq(M, b, x0, reverse):
        Ms = np.asarray(M)[::-1] if reverse else np.asarray(M)
        bs = np.asarray(b)[::-1] if reverse else np.asarray(b)
        xs = [np.asarray(x0)]
        for k in range(N):
            xs.append(Ms[k] @ xs[-1] + bs[k])
        out = np.stack(xs)
        return out[::-1] if reverse else out

    for reverse in (False, True):
        ref = seq(M, b, x0, reverse)
        for block in (None, 8, 13, 57, 100):
            got = np.asarray(_affine_scan(M, b, x0, reverse=reverse,
                                          block=block))
            assert np.allclose(got, ref, atol=1e-5), (reverse, block)


def test_dense_kkt_batched_rhs_matches_single():
    """The reference's batched form (shared matrices, a batch of linear
    terms and initial states against one factorisation) equals one solve
    per problem, and satisfies the dynamics exactly."""
    rng = np.random.default_rng(12)
    F, G, d, Q, R, S, q, r, z0 = random_problem(rng, N=9, nz=5, nc=2)
    qs = np.stack([q, q * -0.5, q + 1.0])
    rs = np.stack([r, r * 2.0, r - 0.3])
    z0s = np.stack([z0, -z0, z0 * 0.1])
    zb, cb = dense_solve(F, G, d, Q, R, S, qs, rs, z0s)
    assert zb.shape == (3, 10, 5) and cb.shape == (3, 9, 2)
    for i in range(3):
        z1, c1 = dense_solve(F, G, d, Q, R, S, qs[i], rs[i], z0s[i])
        np.testing.assert_allclose(zb[i], z1, atol=1e-10)
        np.testing.assert_allclose(cb[i], c1, atol=1e-10)
        for k in range(9):
            np.testing.assert_allclose(
                zb[i, k + 1], F[k] @ zb[i, k] + G[k] @ cb[i, k] + d[k],
                atol=1e-9)


@pytest.mark.parametrize("assoc", [False, True])
def test_riccati_matches_dense_kkt_long_horizon_batch(assoc):
    """The chip_smoke reference check at a CPU-sized width: float32
    Riccati (sequential and blocked-associative affine solves) over a
    vmapped batch at the LPV stage width (nz=11, nc=2) against the float64
    dense KKT, within the stated tolerance."""
    import chip_smoke
    rng = np.random.default_rng(5)
    prob = chip_smoke.stable_lqr_batch(rng, n_mat=2, per_mat=3, N=40)
    err = chip_smoke.riccati_vs_dense(prob, assoc=assoc)
    assert err < chip_smoke.RICCATI_TOL, err
