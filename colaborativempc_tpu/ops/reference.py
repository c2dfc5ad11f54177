"""Plain float64 references for the QP engine.

Independent of the Riccati recursions in ops/lqr.py: the equality-
constrained stage QP is assembled as one dense KKT system and solved by
LU (NumPy, float64, on the host). Used by tests/test_ops.py and by the
``reference`` phase of chip_smoke.py.
"""

from __future__ import annotations

import numpy as np


def dense_kkt_solve(F, G, d, Q, R, S, q, r, z0):
    """Dense KKT solve of

        min  sum_k 1/2 z_k'Q_k z_k + q_k'z_k + 1/2 c_k'R_k c_k + r_k'c_k
                   + z_k'S_k c_k
        s.t. z_{k+1} = F_k z_k + G_k c_k + d_k,  z_0 given,

    with F (N, nz, nz), G (N, nz, nc), d (N, nz), Q (N+1, nz, nz),
    R (N, nc, nc), S (N, nz, nc). The linear terms and the initial state
    may carry one leading batch axis — q (B, N+1, nz), r (B, N, nc),
    z0 (B, nz) — solved against one factorisation of the shared matrix.
    Returns z (..., N+1, nz) with z_0 included, and c (..., N, nc).
    """
    F, G, d, Q, R, S = (np.asarray(a, np.float64) for a in (F, G, d, Q, R, S))
    q, r, z0 = (np.asarray(a, np.float64) for a in (q, r, z0))
    single = z0.ndim == 1
    if single:
        q, r, z0 = q[None], r[None], z0[None]
    N, nz, nc = F.shape[0], F.shape[1], G.shape[2]
    B = z0.shape[0]
    nv = N * nz + N * nc  # z_1..z_N then c_0..c_{N-1}

    def zi(k):  # z_k for k>=1
        return slice((k - 1) * nz, k * nz)

    def ci(k):
        return slice(N * nz + k * nc, N * nz + (k + 1) * nc)

    H = np.zeros((nv, nv))
    g = np.zeros((nv, B))
    for k in range(1, N + 1):
        H[zi(k), zi(k)] += Q[k]
        g[zi(k)] += q[:, k].T
    for k in range(N):
        H[ci(k), ci(k)] += R[k]
        g[ci(k)] += r[:, k].T
        if k >= 1:
            H[zi(k), ci(k)] += S[k]
            H[ci(k), zi(k)] += S[k].T
        else:
            g[ci(0)] += S[0].T @ z0.T

    A = np.zeros((N * nz, nv))
    b = np.zeros((N * nz, B))
    for k in range(N):
        rows = slice(k * nz, (k + 1) * nz)
        A[rows, zi(k + 1)] = np.eye(nz)
        A[rows, ci(k)] = -G[k]
        if k >= 1:
            A[rows, zi(k)] = -F[k]
            b[rows] = d[k][:, None]
        else:
            b[rows] = F[0] @ z0.T + d[0][:, None]

    KKT = np.block([[H, A.T], [A, np.zeros((N * nz, N * nz))]])
    sol = np.linalg.solve(KKT, np.concatenate([-g, b]))
    zs = sol[: N * nz].T.reshape(B, N, nz)
    cs = sol[N * nz: nv].T.reshape(B, N, nc)
    z = np.concatenate([z0[:, None], zs], axis=1)
    return (z[0], cs[0]) if single else (z, cs)
