"""9-state mixed Frenet/Cartesian bicycle model.

State layout (reference LPV_Planner.py:552-571 row comments):
    x = [vx, vy, wz, ey, epsi, theta, s, X, Y]
Inputs:
    u = [delta (steer), a (long. accel)]

Provides, all pure-jnp and vmappable over horizon stages / agents / batches:
- ``f_continuous``: the nonlinear dynamics (reference base_nl.py:231-304)
- ``lpv_matrices``: the LPV A(zeta), B(zeta) reformulation in which
  f(x, u) == A(x) @ x + B(x) @ u exactly (reference LPV_Planner.py:477-591),
  with the same low-velocity straight-line switch at vx < 0.2 expressed as
  ``jnp.where`` masks instead of Python branches
- Euler discretisation ``discretize_euler`` (Ad = I + dt A, reference
  LPV_Planner.py:583-585) and an RK4 step for plant simulation (native
  reference analogue: MPCC-master/C++/Model/integrator.cpp:29-43)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from colaborativempc_tpu.config.params import ModelParams

NX = 9   # states
NU = 2   # inputs
LOW_VEL_THRESH = 0.2  # reference LPV_Planner.py:505


def lpv_coeffs(x: jnp.ndarray, u: jnp.ndarray, kappa, p: ModelParams):
    """Velocity/steering-scheduled entries of the LPV A, B matrices.

    Returns a dict of the scheduled scalar coefficients; the low-velocity
    switch zeroes the 1/vx tire terms (reference LPV_Planner.py:505-531).
    """
    vx, vy, ey, epsi, theta = x[0], x[1], x[3], x[4], x[5]
    delta = u[0]

    low = vx < LOW_VEL_THRESH
    vx_safe = jnp.where(low, 1.0, vx)

    sd, cd = jnp.sin(delta), jnp.cos(delta)
    se, ce = jnp.sin(epsi), jnp.cos(epsi)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    den = 1.0 - ey * kappa

    def gate(v):
        return jnp.where(low, 0.0, v)

    return dict(
        A12=gate(sd * p.Cf / (p.m * vx_safe)),
        A13=gate(sd * p.Cf * p.lf / (p.m * vx_safe) + vy),
        A22=gate(-(p.Cr + p.Cf * cd) / (p.m * vx_safe)),
        A23=gate(-(p.lf * p.Cf * cd - p.lr * p.Cr) / (p.m * vx_safe) - vx),
        A32=gate(-(p.lf * p.Cf * cd - p.lr * p.Cr) / (p.I * vx_safe)),
        A33=gate(-(p.lf ** 2 * p.Cf * cd + p.lr ** 2 * p.Cr) / (p.I * vx_safe)),
        B11=gate(-sd * p.Cf / p.m),
        A41=se, A42=ce,
        A51=-ce * kappa / den, A52=se * kappa / den,
        A61=ce / den, A62=-se / den,
        A81=ct, A82=-st,
        A91=st, A92=ct,
        B21=cd * p.Cf / p.m,
        B31=p.lf * p.Cf * cd / p.I,
    )


def lpv_matrices(x: jnp.ndarray, u: jnp.ndarray, kappa, p: ModelParams):
    """Continuous-time LPV (A, B) at operating point (x, u, kappa).

    A is (9, 9), B is (9, 2); f(x, u) = A @ x + B @ u exactly (the LPV
    embedding is exact, not a Jacobian). Reference LPV_Planner.py:552-571.
    """
    c = lpv_coeffs(x, u, kappa, p)
    z = jnp.zeros(())
    o = jnp.ones(())
    A = jnp.stack([
        jnp.stack([-p.mu * o, c["A12"], c["A13"], z, z, z, z, z, z]),
        jnp.stack([z, c["A22"], c["A23"], z, z, z, z, z, z]),
        jnp.stack([z, c["A32"], c["A33"], z, z, z, z, z, z]),
        jnp.stack([c["A41"], c["A42"], z, z, z, z, z, z, z]),
        jnp.stack([c["A51"], c["A52"], o, z, z, z, z, z, z]),
        jnp.stack([z, z, o, z, z, z, z, z, z]),
        jnp.stack([c["A61"], c["A62"], z, z, z, z, z, z, z]),
        jnp.stack([c["A81"], c["A82"], z, z, z, z, z, z, z]),
        jnp.stack([c["A91"], c["A92"], z, z, z, z, z, z, z]),
    ])
    B = jnp.stack([
        jnp.stack([c["B11"], o]),
        jnp.stack([c["B21"], z]),
        jnp.stack([c["B31"], z]),
        jnp.stack([z, z]), jnp.stack([z, z]), jnp.stack([z, z]),
        jnp.stack([z, z]), jnp.stack([z, z]), jnp.stack([z, z]),
    ])
    return A, B


def f_continuous(x: jnp.ndarray, u: jnp.ndarray, kappa, p: ModelParams):
    """Nonlinear continuous dynamics x' = f(x, u, kappa).

    Written via the exact LPV embedding so the nonlinear and LPV paths share
    one source of truth (the reference duplicates the equations between
    base_nl.py:231-304 and LPV_Planner.py:519-571).
    """
    A, B = lpv_matrices(x, u, kappa, p)
    return (jnp.matmul(A, x, precision=jax.lax.Precision.HIGHEST)
            + jnp.matmul(B, u, precision=jax.lax.Precision.HIGHEST))


def discretize_euler(A: jnp.ndarray, B: jnp.ndarray, dt):
    """Forward-Euler discretisation (reference LPV_Planner.py:583-585)."""
    return jnp.eye(NX, dtype=A.dtype) + dt * A, dt * B


def lpv_discrete_horizon(states: jnp.ndarray, inputs: jnp.ndarray,
                         kappas: jnp.ndarray, dt, p: ModelParams):
    """Batched discrete LPV matrices along a horizon.

    Args:
      states: (N, 9) linearisation trajectory (previous prediction).
      inputs: (N, 2) previous predicted inputs.
      kappas: (N,) curvature at each stage's s.
    Returns: Ad (N, 9, 9), Bd (N, 9, 2).

    The on-device replacement for the per-stage Python loop of
    ``_EstimateABC`` (reference LPV_Planner.py:477-591): one vmap over stages.
    """
    def one(x, u, k):
        A, B = lpv_matrices(x, u, k, p)
        return discretize_euler(A, B, dt)

    return jax.vmap(one)(states, inputs, kappas)


def step_euler(x, u, kappa, dt, p: ModelParams):
    return x + dt * f_continuous(x, u, kappa, p)


def step_rk4(x, u, kappa, dt, p: ModelParams):
    """Classic RK4 with curvature held over the step (plant simulation;
    native reference analogue integrator.cpp:29-43)."""
    k1 = f_continuous(x, u, kappa, p)
    k2 = f_continuous(x + 0.5 * dt * k1, u, kappa, p)
    k3 = f_continuous(x + 0.5 * dt * k2, u, kappa, p)
    k4 = f_continuous(x + dt * k3, u, kappa, p)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
