"""MPCC-style racing planner: progress maximisation + Pacejka physics.

The capability twin of the reference's native contouring controller
(``Matlab-tests/MPCC-master/C++``): a single-agent racing MPC that maximises
track progress subject to contouring accuracy, tire friction-ellipse and
slip-angle limits — built on this framework's Frenet formulation and
Riccati+ADMM engine instead of HPIPM.

Formulation notes vs the reference:
- The reference tracks a Cartesian path via contouring/lag errors computed
  against an arc-length spline with a virtual progress state (cost.cpp
  getContouringCost). In the Frenet formulation the contouring error IS the
  lateral error ey and progress IS the state s — exact, no Taylor
  approximation of the projection needed — so the cost reduces to a linear
  progress reward on s plus quadratic penalties on (ey, epsi) and input
  rates (the reference's q_c, q_l, q_beta analogues).
- Friction-ellipse and slip-angle constraints (constraints.cpp:57,117) are
  linearised per SQP iteration with autodiff and enter as soft rows.
- The SQP loop with solution mixing mirrors mpc.cpp:219-259.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from colaborativempc_tpu.dynamics.bicycle import NX, NU
from colaborativempc_tpu.dynamics.pacejka import (
    PacejkaParams, f_continuous_pacejka, linearize_pacejka,
    friction_ellipse_residual, slip_angle_residuals,
)
from colaborativempc_tpu.geometry import Track, curvature, halfwidth
from colaborativempc_tpu.ops import (
    LQRCost, LQRDynamics, StageQP, admm_solve, scale_stage_qp,
)
from colaborativempc_tpu.planners.lpv import NZ, NC, _augment_dynamics

INF = jnp.inf


class MPCCGains(NamedTuple):
    """Racing cost weights (MPCC-master Params/cost.json analogues)."""
    q_progress: float = 1.0    # linear reward on s advance
    q_contour: float = 50.0    # ey^2
    q_heading: float = 5.0     # epsi^2
    q_vy: float = 0.1
    q_wz: float = 0.1
    r_delta: float = 0.1       # u^2
    r_drive: float = 0.1
    dr_delta: float = 5.0      # du^2
    dr_drive: float = 5.0
    w_soft: float = 1e4        # soft-constraint weight (track/tire rows)


class MPCCBounds(NamedTuple):
    """Input box + SQP trust region (MPCC-master Params/bounds.json deltal/
    deltau/Dl/Du rows; s_trust_region from model.json via mpc.cpp:85-87)."""
    delta_max: float = 0.35    # |steer| bound [rad] (bounds.json deltau)
    drive_min: float = -0.1    # reverse-drive floor (bounds.json Dl)
    drive_max: float = 1.0     # duty ceiling (bounds.json Du)
    trust_delta: float = 0.08  # per-SQP-iteration trust region on steer
    trust_drive: float = 0.3   # ... on duty
    vx_min: float = 0.05       # keep-moving floor (bounds.json vxl)


class MPCCNormalization(NamedTuple):
    """Per-variable scales for the solver's change of variables
    (``Params/params.h:31-58`` NormalizationParam T_x/T_u, applied per SQP
    iteration at ``mpc.cpp:91-132``). Layout follows this framework's state
    [vx, vy, wz, ey, epsi, theta, s, X, Y], input [delta, D] and stage
    control du = per-step input increments (the reference's T_u scales input
    RATES; ours multiplies by dt at load time, see :func:`from_reference`).
    """
    t_x: jnp.ndarray   # (9,)
    t_u: jnp.ndarray   # (2,)
    t_du: jnp.ndarray  # (2,)

    @classmethod
    def default(cls, dt: float = 0.02) -> "MPCCNormalization":
        """Reference normalization.json values mapped onto this layout:
        vx:3, vy:1, r(wz):5, s:20, X/Y:2, phi(theta):1; ey/epsi have no
        reference counterpart (its state is Cartesian) — corridor-scale
        defaults; delta:0.35, D:1; dDelta/dD:15 (rates) x dt."""
        return cls(
            t_x=jnp.asarray([3.0, 1.0, 5.0, 0.25, 0.5, 1.0, 20.0, 2.0, 2.0],
                            jnp.float32),
            t_u=jnp.asarray([0.35, 1.0], jnp.float32),
            t_du=jnp.asarray([15.0 * dt, 15.0 * dt], jnp.float32))

    @classmethod
    def from_reference(cls, path: str, dt: float) -> "MPCCNormalization":
        """Load a reference ``normalization.json`` (keys X, Y, phi, vx, vy,
        r, s, D, delta, dD, dDelta; ``params.cpp`` NormalizationParam)."""
        with open(path) as f:
            d = json.load(f)
        base = cls.default(dt)
        t_x = np.asarray(base.t_x, np.float64)
        for idx, key in ((0, "vx"), (1, "vy"), (2, "r"), (5, "phi"),
                         (6, "s"), (7, "X"), (8, "Y")):
            if key in d:
                t_x[idx] = float(d[key])
        t_u = np.asarray([d.get("delta", 0.35), d.get("D", 1.0)])
        t_du = np.asarray([d.get("dDelta", 15.0), d.get("dD", 15.0)]) * dt
        return cls(t_x=jnp.asarray(t_x, jnp.float32),
                   t_u=jnp.asarray(t_u, jnp.float32),
                   t_du=jnp.asarray(t_du, jnp.float32))

    @property
    def t_z(self) -> jnp.ndarray:
        """Augmented-state scale for z = [x; u_prev]."""
        return jnp.concatenate([self.t_x, self.t_u])


class MPCCSolution(NamedTuple):
    x_pred: jnp.ndarray
    u_pred: jnp.ndarray
    feasible: jnp.ndarray
    r_prim: jnp.ndarray
    iterations: jnp.ndarray
    sqp_fails: jnp.ndarray   # SQP iterations whose QP solve was rejected
    w: jnp.ndarray           # ADMM splitting state (constraint space —
    y: jnp.ndarray           #  invariant under normalisation, warm starts)
    rho_scale: jnp.ndarray


def build_mpcc_qp(track: Track, gains: MPCCGains, p: PacejkaParams,
                  N: int, dt, x_bar: jnp.ndarray, u_bar: jnp.ndarray,
                  bounds: MPCCBounds = MPCCBounds()) -> StageQP:
    """Assemble the racing stage QP around (x_bar, u_bar).

    u = [delta, D] with delta in [-delta_max, delta_max] and
    D in [drive_min, drive_max] (reference bounds.json), plus per-SQP-
    iteration trust regions (mpc.cpp:85-87 s_trust_region analogue on the
    inputs, where the linearisation error actually enters).
    """
    u_box = (bounds.delta_max, bounds.drive_max)
    u_trust = (bounds.trust_delta, bounds.trust_drive)
    dtype = x_bar.dtype
    kappas = curvature(track, x_bar[:N, 6])
    Ad, Bd, rd = jax.vmap(
        lambda x, u, k: linearize_pacejka(x, u, k, p, dt))(
        x_bar[:N], u_bar, kappas)
    dyn = _augment_dynamics(Ad, Bd)
    dyn = dyn._replace(d=dyn.d.at[:, :NX].set(rd))

    # ---- cost ------------------------------------------------------------
    qdiag = jnp.zeros(NZ, dtype)
    qdiag = qdiag.at[1].set(2.0 * gains.q_vy)
    qdiag = qdiag.at[2].set(2.0 * gains.q_wz)
    qdiag = qdiag.at[3].set(2.0 * gains.q_contour)
    qdiag = qdiag.at[4].set(2.0 * gains.q_heading)
    qdiag = qdiag.at[NX + 0].set(2.0 * gains.r_delta)
    qdiag = qdiag.at[NX + 1].set(2.0 * gains.r_drive)
    Q = jnp.zeros((N + 1, NZ, NZ), dtype)
    Q = Q.at[1:].set(jnp.diag(qdiag))
    q = jnp.zeros((N + 1, NZ), dtype)
    q = q.at[1:, 6].set(-2.0 * gains.q_progress)   # maximise progress
    R = jnp.broadcast_to(
        jnp.diag(jnp.asarray([2.0 * gains.dr_delta, 2.0 * gains.dr_drive],
                             dtype)), (N, NC, NC))
    cost = LQRCost(Q=Q, q=q, R=R, r=jnp.zeros((N, NC), dtype),
                   S=jnp.zeros((N, NZ, NC), dtype))

    # ---- constraints -----------------------------------------------------
    m = 7
    D = jnp.zeros((N, m, NZ), dtype)
    E = jnp.zeros((N, m, NC), dtype)
    lo = jnp.full((N, m), -INF, dtype)
    hi = jnp.full((N, m), INF, dtype)
    soft_lo = jnp.full((N, m), INF, dtype)
    soft_hi = jnp.full((N, m), INF, dtype)

    F_, G_ = dyn.F, dyn.G
    d_ = dyn.d  # rows composed through the dynamics see x_{k+1} - d_k

    def next_state_rows(j):
        return F_[:, j, :], G_[:, j, :], d_[:, j]

    # track corridor on ey_{k+1}, soft both sides (constraints.cpp:30)
    ey_ub = halfwidth(track, x_bar[:N, 6], sm=0.95).astype(dtype)
    Dey, Eey, dey = next_state_rows(3)
    D = D.at[:, 0, :].set(Dey); E = E.at[:, 0, :].set(Eey)
    lo = lo.at[:, 0].set(-ey_ub - dey); hi = hi.at[:, 0].set(ey_ub - dey)
    soft_lo = soft_lo.at[:, 0].set(gains.w_soft)
    soft_hi = soft_hi.at[:, 0].set(gains.w_soft)

    # input boxes with SQP trust region
    lo_d = jnp.maximum(-u_box[0], u_bar[:, 0] - u_trust[0])
    hi_d = jnp.minimum(u_box[0], u_bar[:, 0] + u_trust[0])
    lo_D = jnp.maximum(bounds.drive_min, u_bar[:, 1] - u_trust[1])
    hi_D = jnp.minimum(u_box[1], u_bar[:, 1] + u_trust[1])
    D = D.at[:, 1, NX + 0].set(1.0); E = E.at[:, 1, 0].set(1.0)
    lo = lo.at[:, 1].set(lo_d.astype(dtype))
    hi = hi.at[:, 1].set(hi_d.astype(dtype))
    D = D.at[:, 2, NX + 1].set(1.0); E = E.at[:, 2, 1].set(1.0)
    lo = lo.at[:, 2].set(lo_D.astype(dtype))
    hi = hi.at[:, 2].set(hi_D.astype(dtype))

    # tire rows, linearised at (x_bar_k, u_bar_k): value + g.(x - x_bar)
    # + gu.(u - u_bar) <= 0  ->  g.x + gu.u <= g.x_bar + gu.u_bar - value
    def tire_rows(x, u):
        def fe(xx, uu):
            return friction_ellipse_residual(xx, uu, p)

        def sa(xx, uu):
            return slip_angle_residuals(xx, uu, p)

        vals = jnp.concatenate([fe(x, u)[None], sa(x, u)])
        gx = jnp.concatenate([jax.jacfwd(fe, 0)(x, u)[None],
                              jax.jacfwd(sa, 0)(x, u)])
        gu = jnp.concatenate([jax.jacfwd(fe, 1)(x, u)[None],
                              jax.jacfwd(sa, 1)(x, u)])
        return vals, gx, gu

    vals, gx, gu = jax.vmap(tire_rows)(x_bar[:N], u_bar)  # (N,3),(N,3,9),(N,3,2)
    bound = (-vals
             + jnp.einsum("kri,ki->kr", gx, x_bar[:N],
                          precision=jax.lax.Precision.HIGHEST)
             + jnp.einsum("kri,ki->kr", gu, u_bar,
                          precision=jax.lax.Precision.HIGHEST))
    for rr in range(3):
        row = 4 + rr - 1  # rows 3, 4, 5
        D = D.at[:, row, :NX].set(gx[:, rr, :].astype(dtype))
        D = D.at[:, row, NX:].set(gu[:, rr, :].astype(dtype))
        E = E.at[:, row, :].set(gu[:, rr, :].astype(dtype))
        hi = hi.at[:, row].set(bound[:, rr].astype(dtype))
        soft_hi = soft_hi.at[:, row].set(gains.w_soft)

    # vx >= vx_min (keep the car moving forward), soft
    Dv, Ev, dv = next_state_rows(0)
    D = D.at[:, 6, :].set(Dv); E = E.at[:, 6, :].set(Ev)
    lo = lo.at[:, 6].set(bounds.vx_min - dv)
    soft_lo = soft_lo.at[:, 6].set(gains.w_soft)

    return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                   soft_lo=soft_lo, soft_hi=soft_hi)


def mpcc_solve(track: Track, gains: MPCCGains, p: PacejkaParams,
               N: int, dt, x0: jnp.ndarray, x_bar: jnp.ndarray,
               u_bar: jnp.ndarray, u_old: jnp.ndarray,
               sqp_iters: int = 3, sqp_mix: float = 0.7,
               admm_iters: int = 200, rho: float = 10.0,
               bounds: MPCCBounds = MPCCBounds(),
               norm: Optional[MPCCNormalization] = None,
               w0: Optional[jnp.ndarray] = None,
               y0: Optional[jnp.ndarray] = None,
               rho_scale0=1.0,
               epoch_len: Optional[int] = None,
               unroll: Optional[int] = None,
               assoc: bool = False) -> MPCCSolution:
    """SQP racing solve (the reference's runMPC loop, mpc.cpp:219-259).

    ``norm`` applies the reference's per-SQP-iteration state/input
    normalisation (``mpc.cpp:91-132``): each stage QP is solved in scaled
    variables z~ = T_z^-1 z, c~ = T_du^-1 c and the solution de-normalised
    (``deNormalizeSolution``). The ADMM (w, y, rho_scale) states live in
    constraint space — invariant under the scaling — so warm starts carry
    across normalised and raw solves alike.

    A QP outcome is REJECTED (guess kept, no mixing) when it is non-finite;
    finite-but-inaccurate solves are accepted like the reference accepts
    HPIPM status 1 (``mpc.cpp:239-241`` applies the update for
    solver_status <= 1 and counts failures). ``sqp_fails`` reports the
    per-solve rejection count for the driver's n_no_solves bookkeeping
    (``mpc.cpp:231-252``).
    """
    dtype = x_bar.dtype
    z0 = jnp.concatenate([x0, u_old]).astype(dtype)
    if norm is not None:
        tz = norm.t_z.astype(dtype)
        tc = norm.t_du.astype(dtype)
        z0_s = z0 / tz

    def sqp_iter(carry, _):
        x_lin, u_lin, w, y, rs = carry
        qp = build_mpcc_qp(track, gains, p, N, dt, x_lin, u_lin, bounds)
        if norm is not None:
            sol = admm_solve(scale_stage_qp(qp, tz, tc), z0_s,
                             w0=w, y0=y, rho_scale0=rs,
                             iters=admm_iters, rho=rho,
                             epoch_len=epoch_len, unroll=unroll,
                             assoc=assoc)
            z_sol = sol.z * tz[None, :]
        else:
            sol = admm_solve(qp, z0, w0=w, y0=y, rho_scale0=rs,
                             iters=admm_iters, rho=rho,
                             epoch_len=epoch_len, unroll=unroll,
                             assoc=assoc)
            z_sol = sol.z
        x_new = z_sol[:, :NX]
        u_new = z_sol[1:, NX:]
        ok = (jnp.all(jnp.isfinite(x_new)) & jnp.all(jnp.isfinite(u_new)))
        mix = jnp.where(ok, jnp.asarray(sqp_mix, dtype), 0.0)
        x_mix = mix * x_new + (1.0 - mix) * x_lin
        u_mix = mix * u_new + (1.0 - mix) * u_lin
        w_n = jnp.where(ok, sol.w, w)
        y_n = jnp.where(ok, sol.y, y)
        rs_n = jnp.where(ok, sol.rho_scale, rs)
        # the reference counts EVERY solver_status != 0 toward
        # n_no_solves_sqp_ — including accepted-inaccurate status-1 solves
        # whose update IS applied (mpc.cpp:239-244 status<=1 apply /
        # status!=0 count split). Mirror that: finite-but-infeasible solves
        # are mixed in (ok) but still count as fails so the driver's
        # n_reset ladder triggers under persistent inaccuracy.
        fail = (~ok) | (~sol.feasible)
        stats = (sol.feasible, sol.r_prim, sol.iterations, fail)
        return (x_mix, u_mix, w_n, y_n, rs_n), stats

    m = 7
    if w0 is None:
        w0 = jnp.zeros((N, m), dtype)
    if y0 is None:
        y0 = jnp.zeros((N, m), dtype)
    rs0 = jnp.broadcast_to(jnp.asarray(rho_scale0, dtype), (m,))
    (x_fin, u_fin, w_fin, y_fin, rs_fin), stats = jax.lax.scan(
        sqp_iter, (x_bar, u_bar, w0, y0, rs0), None, length=sqp_iters)
    feas, r_prim, iters, fails = stats
    return MPCCSolution(x_pred=x_fin, u_pred=u_fin,
                        feasible=feas[-1], r_prim=r_prim[-1],
                        iterations=jnp.sum(iters),
                        sqp_fails=jnp.sum(fails.astype(jnp.int32)),
                        w=w_fin, y=y_fin, rho_scale=rs_fin)


# ---------------------------------------------------------------------------
# Config surface (the reference's JSON-driven Params/ layout, main.cpp:33-41)
# ---------------------------------------------------------------------------

def pacejka_from_reference(path: str) -> PacejkaParams:
    """Load a reference ``model.json`` into :class:`PacejkaParams`
    (``Params/params.cpp`` Param(file); key renames: Iz -> I,
    E_long -> p_long, E_eps -> p_ell, maxAlpha -> max_alpha)."""
    with open(path) as f:
        d = json.load(f)
    base = PacejkaParams()._asdict()
    renames = {"Iz": "I", "E_long": "p_long", "E_eps": "p_ell",
               "maxAlpha": "max_alpha"}
    for k, v in d.items():
        k = renames.get(k, k)
        if k in base:
            base[k] = float(v)
    return PacejkaParams(**base)


def mpcc_gains_from_reference(path: str, dt: float) -> MPCCGains:
    """Map a reference ``cost.json`` onto :class:`MPCCGains`.

    The mapping is structural, not numerical parity: in this framework's
    Frenet formulation the contouring error IS ey and the lag error is zero
    by construction (no virtual progress state), so qC -> q_contour,
    qMu -> q_heading, qVs -> q_progress; input-rate weights rdDelta/rdD are
    per-second rates in the reference and per-step increments here
    (divide by dt^2); soft-constraint weights take the stiffest
    sc_quad_* row. Re-tuning is expected when transplanting gains across
    the two formulations.
    """
    with open(path) as f:
        d = json.load(f)
    g = MPCCGains()
    return MPCCGains(
        q_progress=float(d.get("qVs", g.q_progress)),
        q_contour=float(d.get("qC", g.q_contour)),
        q_heading=float(d.get("qMu", g.q_heading)),
        q_vy=float(d.get("qBeta", g.q_vy)),
        q_wz=float(d.get("qR", g.q_wz)),
        r_delta=float(d.get("rDelta", g.r_delta)),
        r_drive=float(d.get("rD", g.r_drive)),
        dr_delta=float(d.get("rdDelta", g.dr_delta * dt * dt)) / (dt * dt),
        dr_drive=float(d.get("rdD", g.dr_drive * dt * dt)) / (dt * dt),
        w_soft=max(float(d.get("sc_quad_track", 100.0)),
                   float(d.get("sc_quad_tire", 1.0)),
                   float(d.get("sc_quad_alpha", 10.0))) * 1e2)


def mpcc_bounds_from_reference(path: str, trust_delta: float = 0.08,
                               trust_drive: float = 0.3) -> MPCCBounds:
    """Load a reference ``bounds.json`` (deltau/Dl/Du/vxl rows) into
    :class:`MPCCBounds`; SQP trust regions have no reference counterpart
    (it trust-regions s instead, mpc.cpp:85-87) and keep their defaults."""
    with open(path) as f:
        d = json.load(f)
    b = MPCCBounds()
    return MPCCBounds(
        delta_max=float(d.get("deltau", b.delta_max)),
        drive_min=float(d.get("Dl", b.drive_min)),
        drive_max=float(d.get("Du", b.drive_max)),
        trust_delta=trust_delta, trust_drive=trust_drive,
        vx_min=float(d.get("vxl", b.vx_min)))


@dataclasses.dataclass(frozen=True)
class MPCCConfig:
    """Racing-experiment description (the reference's ``Params/config.json``
    master file, ``main.cpp:33-41``, as a typed config like every other
    planner family in this framework)."""
    N: int = 20                  # horizon (reference config.h N=60)
    dt: float = 0.05             # control period Ts
    n_sim: int = 400             # closed-loop steps (config.json n_sim)
    n_sqp: int = 3               # SQP iterations per step (n_sqp)
    n_reset: int = 5             # consecutive failed steps before guess reset
    sqp_mixing: float = 0.7      # solution blending (sqp_mixing)
    map_type: str = "oval_mt"    # named track (ignored when track_json set)
    track_json: Optional[str] = None   # reference-format track JSON to fit
    laps: int = 0                # terminate after laps (0 = run n_sim steps)
    initial_velocity: float = 0.5      # cold-start guess speed (v0)
    plant_substeps: int = 4      # RK4 sub-steps per control period
                                 # (integrator.cpp simTimeStep fine steps)
    normalize: bool = True       # solve in normalised variables (params.h T_x/T_u)
    # reference normalization.json supplying the T_x/T_u scales (loaded by
    # mpcc_config_from_json from the master file's normalization_path,
    # main.cpp:33-41); None = MPCCNormalization.default(dt)
    normalization_path: Optional[str] = None
    admm_iters: int = 200
    rho: float = 10.0
    # Riccati scheduling passthrough (ops/admm.py admm_solve; None = the
    # N-dependent defaults). assoc = blocked log-depth affine solves.
    # assoc=None resolves to True at N >= 48 with epoch_len 15 — the
    # same single-fleet latency schedule as the collaborative planners
    # (runtime/simulate.py resolve_single_fleet_schedule), chosen on the
    # racing driver at the reference's N=60 for lower step latency with
    # identical race progress on another accelerator; it awaits
    # re-measurement on the H100. Pin True/False to override; short
    # horizons (N < 48) keep the sequential scan (assoc pays ~3x FLOPs).
    epoch_len: Optional[int] = None
    unroll: Optional[int] = None
    assoc: Optional[bool] = None

    def resolved_assoc(self) -> bool:
        return self.N >= 48 if self.assoc is None else self.assoc

    def resolved_epoch_len(self) -> Optional[int]:
        if self.epoch_len is not None:
            return self.epoch_len
        return 15 if self.resolved_assoc() and self.N >= 48 else None
    gains: MPCCGains = MPCCGains()
    bounds: MPCCBounds = MPCCBounds()
    model: PacejkaParams = PacejkaParams()
    save_data: bool = False
    path: str = "data/mpcc"
    verb: int = 0

    def normalization(self) -> Optional[MPCCNormalization]:
        if not self.normalize:
            return None
        if self.normalization_path is not None:
            return MPCCNormalization.from_reference(self.normalization_path,
                                                    self.dt)
        return MPCCNormalization.default(self.dt)


def _resolve(base_dir: str, rel: str) -> str:
    """Resolve a reference config's sub-path (given relative to the C++
    working dir, e.g. "Params/model.json") against the master file's dir."""
    for cand in (os.path.join(base_dir, rel),
                 os.path.join(base_dir, os.path.basename(rel)),
                 os.path.join(os.path.dirname(base_dir.rstrip(os.sep)), rel),
                 rel):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"cannot resolve {rel!r} against {base_dir!r}")


def mpcc_config_from_json(path: str, **overrides) -> MPCCConfig:
    """Build an :class:`MPCCConfig` from JSON.

    Accepts BOTH layouts:
    - the reference master file (keys n_sqp/n_reset/sqp_mixing/n_sim/Ts/v0 +
      model_path/cost_path/bounds_path/track_path/normalization_path,
      ``Params/config.json`` via ``main.cpp:33-41``) — sub-files are loaded
      through the ``*_from_reference`` mappers and the track JSON is fitted
      at driver time;
    - a flat dict of MPCCConfig field names (native schema, written by
      :func:`mpcc_config_to_json`) with nested gains/bounds/model dicts.
    """
    with open(path) as f:
        raw = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    if "model_path" in raw:                    # reference master layout
        dt = float(raw.get("Ts", 0.02))
        kw = dict(
            dt=dt,
            n_sqp=int(raw.get("n_sqp", 2)),
            n_reset=int(raw.get("n_reset", 5)),
            sqp_mixing=float(raw.get("sqp_mixing", 0.8)),
            n_sim=int(raw.get("n_sim", 400)),
            initial_velocity=float(raw.get("v0", 0.5)),
            model=pacejka_from_reference(
                _resolve(base_dir, raw["model_path"])),
            track_json=_resolve(base_dir, raw["track_path"]),
        )
        if "cost_path" in raw:
            kw["gains"] = mpcc_gains_from_reference(
                _resolve(base_dir, raw["cost_path"]), dt)
        if "bounds_path" in raw:
            kw["bounds"] = mpcc_bounds_from_reference(
                _resolve(base_dir, raw["bounds_path"]))
        if "normalization_path" in raw:
            kw["normalization_path"] = _resolve(
                base_dir, raw["normalization_path"])
        kw.update(overrides)
        return MPCCConfig(**kw)
    # flat native layout
    kw = {}
    for f_ in dataclasses.fields(MPCCConfig):
        if f_.name not in raw:
            continue
        v = raw[f_.name]
        if f_.name == "gains":
            v = MPCCGains(**v)
        elif f_.name == "bounds":
            v = MPCCBounds(**v)
        elif f_.name == "model":
            v = PacejkaParams(**v)
        kw[f_.name] = v
    kw.update(overrides)
    return MPCCConfig(**kw)


def mpcc_config_to_json(cfg: MPCCConfig, path: str) -> None:
    """Serialise an :class:`MPCCConfig` to the flat native JSON layout."""
    d = dataclasses.asdict(cfg)
    for k in ("gains", "bounds", "model"):
        d[k] = {kk: float(vv) for kk, vv in getattr(cfg, k)._asdict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)
