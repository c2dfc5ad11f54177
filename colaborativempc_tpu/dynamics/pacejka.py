"""Dynamic bicycle model with Pacejka magic-formula tires.

The reference's native MPCC controller uses this model family
(``Matlab-tests/MPCC-master/C++/Model/model.cpp:42-71``): lateral tire
forces from the magic formula, drivetrain force ``F_rx = Cm1 D - Cm2 D vx``,
rolling/drag friction, and the friction-ellipse / slip-angle constraints
(``Constraints/constraints.cpp:57,117``). Re-implemented here on the
framework's 9-state Frenet/Cartesian layout so the same planners, tracks and
runtimes work with either tire model; Jacobians come from autodiff instead
of the reference's hand-derived expressions.

State: [vx, vy, wz, ey, epsi, theta, s, X, Y]; input: [delta, D] where D is
the drivetrain duty (the reference MPCC's D) rather than raw acceleration.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp



class PacejkaParams(NamedTuple):
    """Magic-formula + drivetrain parameters (MPCC-master model.cpp naming,
    defaults scaled to the 1:43 car the reference targets)."""
    m: float = 0.041
    I: float = 27.8e-6
    lf: float = 0.029
    lr: float = 0.033
    # front/rear magic formula
    Bf: float = 2.579
    Cf: float = 1.2
    Df: float = 0.192
    Br: float = 3.3852
    Cr: float = 1.2691
    Dr: float = 0.1737
    # drivetrain / friction
    Cm1: float = 0.287
    Cm2: float = 0.0545
    Cr0: float = 0.0518
    Cr2: float = 0.00035
    # friction-ellipse shape (constraints.cpp)
    p_long: float = 0.9
    p_ell: float = 0.95
    max_alpha: float = 0.6  # front slip-angle bound [rad]


def slip_angles(x: jnp.ndarray, u: jnp.ndarray, p: PacejkaParams):
    """Front/rear slip angles (model.cpp getSlipAngleFront/Rear)."""
    vx = jnp.maximum(x[0], 0.3)  # vxNonZero guard (types.h:62-83)
    af = -jnp.arctan2(x[1] + p.lf * x[2], vx) + u[0]
    ar = -jnp.arctan2(x[1] - p.lr * x[2], vx)
    return af, ar


def tire_forces(x: jnp.ndarray, u: jnp.ndarray, p: PacejkaParams):
    """(F_fy, F_ry, F_rx): magic-formula lateral forces + drivetrain."""
    af, ar = slip_angles(x, u, p)
    F_fy = p.Df * jnp.sin(p.Cf * jnp.arctan(p.Bf * af))
    F_ry = p.Dr * jnp.sin(p.Cr * jnp.arctan(p.Br * ar))
    vx = x[0]
    F_rx = p.Cm1 * u[1] - p.Cm2 * u[1] * vx - p.Cr0 - p.Cr2 * vx * vx
    return F_fy, F_ry, F_rx


def f_continuous_pacejka(x: jnp.ndarray, u: jnp.ndarray, kappa,
                         p: PacejkaParams):
    """Nonlinear dynamics x' = f(x, u) on the 9-state Frenet/Cartesian
    layout (body dynamics from model.cpp getF; Frenet kinematics shared with
    the linear-tire model)."""
    vx, vy, wz = x[0], x[1], x[2]
    ey, epsi, theta = x[3], x[4], x[5]
    delta = u[0]
    F_fy, F_ry, F_rx = tire_forces(x, u, p)

    dvx = (F_rx - F_fy * jnp.sin(delta) + p.m * vy * wz) / p.m
    dvy = (F_ry + F_fy * jnp.cos(delta) - p.m * vx * wz) / p.m
    dwz = (F_fy * p.lf * jnp.cos(delta) - F_ry * p.lr) / p.I

    se, ce = jnp.sin(epsi), jnp.cos(epsi)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    den = 1.0 - ey * kappa
    dey = se * vx + ce * vy
    depsi = (-ce * kappa / den) * vx + (se * kappa / den) * vy + wz
    dtheta = wz
    ds = (ce / den) * vx + (-se / den) * vy
    dX = ct * vx - st * vy
    dY = st * vx + ct * vy
    return jnp.stack([dvx, dvy, dwz, dey, depsi, dtheta, ds, dX, dY])


def friction_ellipse_residual(x: jnp.ndarray, u: jnp.ndarray,
                              p: PacejkaParams):
    """Rear-tire friction ellipse value; feasible when <= 0
    (constraints.cpp:57: (p_long F_rx)^2 + F_ry^2 <= (p_ell Dr)^2)."""
    _, F_ry, F_rx = tire_forces(x, u, p)
    return ((p.p_long * F_rx) ** 2 + F_ry ** 2
            - (p.p_ell * p.Dr) ** 2)


def slip_angle_residuals(x: jnp.ndarray, u: jnp.ndarray, p: PacejkaParams):
    """Front slip-angle box residuals; feasible when both <= 0
    (constraints.cpp:117: |alpha_f| <= max_alpha)."""
    af, _ = slip_angles(x, u, p)
    return jnp.stack([af - p.max_alpha, -p.max_alpha - af])


def linearize_pacejka(x: jnp.ndarray, u: jnp.ndarray, kappa,
                      p: PacejkaParams, dt):
    """Discrete (Ad, Bd, rd) of the Euler-discretised Pacejka dynamics via
    autodiff (the reference hand-derives these Jacobians,
    model.cpp:73-160+)."""
    def fd(xx, uu):
        return xx + dt * f_continuous_pacejka(xx, uu, kappa, p)

    Ad = jax.jacfwd(fd, argnums=0)(x, u)
    Bd = jax.jacfwd(fd, argnums=1)(x, u)
    rd = (fd(x, u) - jnp.matmul(Ad, x, precision=jax.lax.Precision.HIGHEST)
          - jnp.matmul(Bd, u, precision=jax.lax.Precision.HIGHEST))
    return Ad, Bd, rd
