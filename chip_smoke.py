#!/usr/bin/env python
"""Smoke run of the collaborative-MPC engine on one GPU.

Drives the system's main paths once, through the entry points a user
calls, at the upstream deployments' full widths, checks what comes out,
and compares the GPU's results with the plain references:

- ``lpv``: ``run_lpv_experiment``, 3 agents, N=125, dt=0.025, Highway;
- ``nl``: ``run_nl_experiment``, 3 agents, N=20, dt=0.02, eu coupling;
- ``batch``: the ``bench.py`` program, 256 scenarios x 3 agents, H=20;
- ``mpcc``: ``make_mpcc_step``, N=60, dt=0.05, on ``oval_mt``;
- ``reference``: float32 Riccati against the float64 dense KKT solve;
  the GPU epoch kernel against the XLA epoch, alone and inside whole
  ``admm_solve`` runs; and the ``lpv`` loop's first 20 steps against
  float64 on the CPU, one step at a time and as a free-running loop.

With ``--four`` only the four-card phase runs: the sharded LPV and NL-OCD
rollouts on a (4, 1) ("scen", "agent") mesh and the hp_opt NL-OCD step on
a (1, 4) mesh, each against the unsharded program on one card, step by
step from the same state.

Every phase raises on a failed check. The last line of standard output is
one JSON object with the device; it is printed only when every phase
passed, and the script exits non-zero without it where JAX finds no GPU.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from functools import partial

import numpy as np

# Tolerances. The solver runs float32 with every product pinned to full
# precision (Precision.HIGHEST, never TF32); ADMM stops at residual
# eps=1e-4 (SolverConfig.eps).
#: Riccati (float32) against the float64 dense KKT solve, as the largest
#: error over the largest state magnitude: float32 roundoff (~1e-7) grown
#: through N=125 stages of a stable recursion stays far below 1e-4.
RICCATI_TOL = 1e-4
#: GPU epoch kernel against the XLA epoch on identical inputs: the same
#: float32 iterations summed in another order; 20 iterations of N=20
#: stages keep the difference at roundoff scale.
KERNEL_TOL = 1e-4
#: ``admm_solve`` with its epochs in the GPU kernel against the same
#: solves on the XLA epoch (768 problems, N=20, adaptive rho), relative to
#: each field's largest value, over the problems whose iteration counts
#: agree. Primal z, c, w: the same iterations to the same eps, measured
#: <= 8.4e-5 on the H100 and 1.9e-4 on the CPU.
ADMM_PRIMAL_TOL = 1e-3
#: Multipliers rho * rho_scale * y are less determined: against the
#: float64 solve of the same problems, the XLA epoch's are off by up to
#: 1.0e-3 and the kernel's by 1.6e-3 (H100), so two float32 solves may
#: differ by their sum; measured 2.6e-3 and 2.8e-4 on two problem sets.
ADMM_DUAL_TOL = 1e-2
#: One ``lpv`` control step (N=125) repeated from the float32 loop's own
#: state in float64 on the CPU, for each of the first 20 steps: largest
#: difference of the executed states and applied inputs. This is one
#: solve's error, nothing carried over. Measured: <= 1.8e-4 on the H100
#: (associative scan and sequential recursion alike), <= 7.2e-4 on a CPU;
#: with every precision pin removed (float32 products in TF32 on the
#: card), 1.44 (states) and 5.39 (inputs). The limit lies between.
STEP_TOL = 1e-2
#: The same 20 steps as free-running loops, float32 on the card against
#: float64 on the CPU: largest difference of the executed positions (ey,
#: s, X, Y; metres). Each step's error above is amplified by the closed
#: loop: the loops agree to 7e-6 m for 5 steps, part at step 5 and drift
#: apart while the yaw rate swings by up to 1.5 rad/s, so drift samples
#: the amplification, not the precision: 0.0063-0.0075 m (sequential
#: recursion, CPU and H100), 0.019 m (associative scan, CPU), 0.065 m
#: (associative scan, H100). With every pin removed: 0.331 m. The limit
#: lies between (the geometric mean of 0.065 and 0.331).
CLOSED_LOOP_TOL = 0.15
#: State components compared by the closed-loop check: ey, s, X, Y.
POSITION_STATES = (3, 6, 7, 8)
#: Sharded against unsharded, one control step at a time from the same
#: state, full executed states and plans, at the users' solver settings.
#: The two programs run the same per-problem arithmetic; only reductions
#: across agents (OCD) may sum in another order. On a 4-device CPU mesh:
#: LPV bit-identical, NL-OCD 4.2e-5, hp_opt 9.2e-6.
SHARD_TOL = 5e-4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu(count: int):
    """The JAX devices, when they are at least ``count`` GPUs; exits
    non-zero otherwise (no fallback to the CPU)."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX finds no GPU (platform "
                 f"{devices[0].platform!r}); nothing was run")
    if len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX finds {len(devices)}")
    return devices


def say(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def compile_report(phase: str, jitted, *args):
    """AOT-compile a jitted step: compile seconds and memory_analysis."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    say(phase, compile_s=secs,
        memory=(None if mem is None else
                dict(argument=mem.argument_size_in_bytes,
                     output=mem.output_size_in_bytes,
                     temp=mem.temp_size_in_bytes,
                     code=mem.generated_code_size_in_bytes)))
    return compiled


def step_stats(phase: str, times):
    """p50/p95 of the steps after the first (which loads the program)."""
    t = np.asarray(times[1:] if len(times) > 1 else times) * 1e3
    say(phase, first_step_ms=times[0] * 1e3, steps=len(times),
        p50_ms=float(np.percentile(t, 50)), p95_ms=float(np.percentile(t, 95)))


def floor_ok(cfg, states0, min_dist_exec) -> bool:
    """Executed separation never below the safety filter's floor
    exec_sep_frac * min_dist, or the start distance if already closer."""
    xy = np.asarray(states0)[:, 7:9]
    d0 = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    d0 = d0[~np.eye(len(xy), dtype=bool)].min()
    floor = min(cfg.exec_sep_frac * cfg.limits.min_dist, d0)
    return float(np.min(min_dist_exec)) >= floor - 1e-4


# ---------------------------------------------------------------- phases


def lpv_config(steps: int, N: int = 125, n_agents: int = 3):
    from colaborativempc_tpu.config import ExperimentConfig, lpv_gains
    return ExperimentConfig(n_agents=n_agents, N=N, dt=0.025,
                            map_type="Highway", gains=lpv_gains(),
                            max_it=steps)


def phase_lpv(steps: int = 150, N: int = 125, n_agents: int = 3):
    """The upstream LPV deployment through run_lpv_experiment, with the
    default SolverConfig (the cmpc-lpv schedule)."""
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime import (
        init_lpv_fleet, make_lpv_fleet_step, run_lpv_experiment)
    from colaborativempc_tpu.runtime.simulate import (
        resolve_single_fleet_schedule)
    cfg = lpv_config(steps, N, n_agents)
    track = make_track(cfg.map_type)
    sched = resolve_single_fleet_schedule(cfg)
    state = init_lpv_fleet(track, sched)
    compile_report("lpv", make_lpv_fleet_step(track, sched), state)
    res = run_lpv_experiment(cfg, track=track)
    step_stats("lpv", res.step_times)
    held = int((~res.feasible).sum())
    say("lpv", feasible_share=float(res.feasible.mean()),
        held_agent_steps=held,
        steps_with_hold=int((~res.feasible).any(axis=1).sum()),
        min_dist_exec=float(res.min_dist_exec.min()),
        mean_admm_iters=float(res.iterations.mean()))
    check(res.steps == steps, f"lpv ran {res.steps} of {steps} steps")
    check(bool(np.all(np.isfinite(res.states))), "lpv: non-finite state")
    check(floor_ok(cfg, np.asarray(state.x0), res.min_dist_exec),
          "lpv: executed separation below the safety floor")
    say("lpv", check="finite states, steps complete, separation >= floor")
    return res


def phase_nl(steps: int = 60, N: int = 20, n_agents: int = 3):
    """The upstream NL-OCD deployment through run_nl_experiment, with the
    cmpc-nl solver settings."""
    from colaborativempc_tpu.config import (
        ExperimentConfig, nl_gains, OCDConfig, SolverConfig)
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime import run_nl_experiment
    from colaborativempc_tpu.runtime.ocd import init_nl_fleet, make_nl_ocd_step
    cfg = ExperimentConfig(
        n_agents=n_agents, N=N, dt=0.02, max_it=steps, map_type="Highway",
        coupling="eu", gains=nl_gains(), ocd=OCDConfig(max_it_ocd=50),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    track = make_track(cfg.map_type)
    state = init_nl_fleet(track, cfg)
    compile_report("nl", make_nl_ocd_step(track, cfg), state)
    res = run_nl_experiment(cfg, track=track)
    step_stats("nl", res.step_times)
    say("nl", ocd_iters_mean=float(res.ocd_iterations.mean()),
        ocd_iters_max=int(res.ocd_iterations.max()),
        feasible_share=float(res.feasible.mean()),
        min_dist_exec=float(res.min_dist_exec.min()))
    check(res.steps == steps, f"nl ran {res.steps} of {steps} steps")
    check(bool(np.all(np.isfinite(res.states))), "nl: non-finite state")
    check(floor_ok(cfg, np.asarray(state.x0), res.min_dist_exec),
          "nl: executed separation below the safety floor")
    say("nl", check="finite states, steps complete, separation >= floor")
    return res


def phase_batch(n_scen: int = 256, horizon: int = 20, steps: int = 20,
                card: str = ""):
    """The bench.py program: one scanned rollout after warm-up."""
    import jax
    import bench
    rollout, state = bench.build(n_scen=n_scen, horizon=horizon,
                                 steps=steps)
    compiled = compile_report("batch", rollout, state)
    state, _ = jax.block_until_ready(compiled(state))          # warm-up
    t0 = time.perf_counter()
    state, (x0_h, _, metrics) = jax.block_until_ready(compiled(state))
    secs = time.perf_counter() - t0
    solves = n_scen * bench.N_AGENTS * steps
    feas = float(np.asarray(metrics.feasible).mean())
    say("batch", solves_per_s=solves / secs, rollout_s=secs,
        feasible_share=feas, card=repr(card))
    check(bool(np.all(np.isfinite(np.asarray(x0_h)))),
          "batch: non-finite state")
    check(x0_h.shape == (n_scen, steps, bench.N_AGENTS, 9),
          f"batch: history shape {x0_h.shape}")
    check(feas > 0.9, f"batch: feasible share {feas}")
    say("batch", check="finite states, shapes, feasible share > 0.9")


def phase_mpcc(steps: int = 60, N: int = 60):
    """The racing driver's control step at the upstream MPCC setting."""
    import jax
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.planners import MPCCConfig
    from colaborativempc_tpu.runtime.racing import init_mpcc, make_mpcc_step
    cfg = MPCCConfig(N=N, dt=0.05, map_type="oval_mt")
    track = make_track(cfg.map_type)
    state = init_mpcc(track, cfg)
    step = make_mpcc_step(track, cfg)
    compile_report("mpcc", step, state)
    times, feas, xs = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state)
        state = jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
        feas.append(bool(m.feasible))
        xs.append(np.asarray(state.x))
    xs = np.asarray(xs)
    step_stats("mpcc", times)
    say("mpcc", progress_m=float(xs[-1, 6] - xs[0, 6]),
        feasible_share=float(np.mean(feas)))
    check(bool(np.all(np.isfinite(xs))), "mpcc: non-finite state")
    check(float(xs[-1, 6]) > float(xs[0, 6]), "mpcc: no progress")
    check(bool(np.all(np.diff(xs[:, 6]) > -1e-3)), "mpcc: went backwards")
    say("mpcc", check="finite states, monotone progress")


# ------------------------------------------------------------ references


def stable_lqr_batch(rng, n_mat: int, per_mat: int, N: int,
                     nz: int = 11, nc: int = 2):
    """``n_mat`` random stage systems with stable dynamics (the LPV stage
    width by default), each with ``per_mat`` linear terms and initial
    states: n_mat * per_mat problems."""
    F = np.eye(nz) * 0.95 + rng.normal(size=(n_mat, N, nz, nz)) * 0.03
    G = rng.normal(size=(n_mat, N, nz, nc)) * 0.2
    d = rng.normal(size=(n_mat, N, nz)) * 0.05

    def spd(shape, n, scale):
        A = rng.normal(size=shape + (n, n))
        return A @ np.swapaxes(A, -1, -2) * scale + np.eye(n)

    Q = spd((n_mat, N + 1), nz, 0.1)
    R = spd((n_mat, N), nc, 0.1)
    S = rng.normal(size=(n_mat, N, nz, nc)) * 0.05
    q = rng.normal(size=(n_mat, per_mat, N + 1, nz)) * 0.5
    r = rng.normal(size=(n_mat, per_mat, N, nc)) * 0.5
    z0 = rng.normal(size=(n_mat, per_mat, nz))
    return dict(F=F, G=G, d=d, Q=Q, R=R, S=S, q=q, r=r, z0=z0)


def riccati_vs_dense(prob, assoc: bool) -> float:
    """Largest error of the float32 Riccati solve (on the default device)
    against the float64 dense KKT solve (host), over the largest state."""
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.ops.lqr import (
        LQRCost, LQRDynamics, lqr_factorize, lqr_affine_solve,
        lqr_affine_solve_assoc)
    from colaborativempc_tpu.ops.reference import dense_kkt_solve
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    affine = lqr_affine_solve_assoc if assoc else lqr_affine_solve

    def one(F, G, d, Q, R, S, q, r, z0):
        dyn = LQRDynamics(F, G, d)
        fac = lqr_factorize(dyn, LQRCost(Q, q[0], R, r[0], S))
        return jax.vmap(lambda qq, rr, zz: affine(dyn, fac, qq, rr, zz))(
            q, r, z0)

    p = {k: f32(v) for k, v in prob.items()}
    z, c = jax.block_until_ready(jax.jit(jax.vmap(one))(
        p["F"], p["G"], p["d"], p["Q"], p["R"], p["S"], p["q"], p["r"],
        p["z0"]))
    err, scale = 0.0, 0.0
    for i in range(prob["F"].shape[0]):
        zr, cr = dense_kkt_solve(*(prob[k][i] for k in
                                   ("F", "G", "d", "Q", "R", "S", "q", "r",
                                    "z0")))
        err = max(err, float(np.abs(np.asarray(z[i]) - zr).max()),
                  float(np.abs(np.asarray(c[i]) - cr).max()))
        scale = max(scale, float(np.abs(zr).max()), float(np.abs(cr).max()))
    return err / max(scale, 1.0)


def random_epoch_batch(rng, B: int, N: int, nz: int = 11, nc: int = 2,
                       m: int = 6, rho: float = 10.0):
    """A batch of ADMM epoch inputs (ops/admm.py EpochData) at the fleet
    stage width, with one one-sided row and one soft row per stage."""
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.ops.admm import (
        EpochData, StageQP, build_admm_cost)
    from colaborativempc_tpu.ops.lqr import (
        LQRCost, LQRDynamics, lqr_factorize)
    prob = stable_lqr_batch(rng, B, 1, N, nz, nc)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    lo = -np.abs(rng.normal(size=(B, N, m))) * 0.3
    lo[..., 0] = -np.inf
    hi = np.abs(rng.normal(size=(B, N, m))) * 0.3
    soft = np.full((B, N, m), np.inf)
    soft[..., 1] = 50.0
    qp = StageQP(
        dyn=LQRDynamics(f32(prob["F"]), f32(prob["G"]), f32(prob["d"])),
        cost=LQRCost(f32(prob["Q"]), f32(prob["q"][:, 0]), f32(prob["R"]),
                     f32(prob["r"][:, 0]), f32(prob["S"])),
        D=f32(rng.normal(size=(B, N, m, nz)) * 0.3),
        E=f32(rng.normal(size=(B, N, m, nc)) * 0.3),
        lo=f32(lo), hi=f32(hi), soft_lo=f32(soft), soft_hi=f32(soft))

    def data_of(qp):
        rv = jnp.full(qp.lo.shape, rho, jnp.float32)
        aug = build_admm_cost(qp, rv)
        fac = lqr_factorize(qp.dyn, aug)
        shrink = jnp.where(jnp.isinf(qp.soft_lo), 0.0,
                           rv / (rv + 2.0 * qp.soft_lo))
        return EpochData(dyn=qp.dyn, fac=fac, q=aug.q, r=aug.r, D=qp.D,
                         E=qp.E, lo=qp.lo, hi=qp.hi, rv=rv,
                         fac_lo=shrink, fac_hi=shrink)

    data = jax.jit(jax.vmap(data_of))(qp)
    z0 = f32(prob["z0"][:, 0])
    w = jnp.clip(jnp.zeros((B, N, m), jnp.float32), data.lo, data.hi)
    y = f32(rng.normal(size=(B, N, m)) * 0.05)
    return data, z0, w, y


def kernel_vs_xla(rng, B: int, N: int, epoch_len: int = 20,
                  interpret: bool = False):
    """The GPU epoch kernel (or its interpreter) against the XLA epoch on
    the same batch: largest difference over all outputs, and each one's
    time per epoch on the default device."""
    import jax
    from colaborativempc_tpu.ops.admm import epoch_iterations_xla
    from colaborativempc_tpu.ops.admm_kernel import admm_epoch_kernel
    data, z0, w, y = random_epoch_batch(rng, B, N)
    xla = jax.jit(jax.vmap(partial(epoch_iterations_xla,
                                   epoch_len=epoch_len, alpha=1.6)))
    ker = jax.jit(jax.vmap(partial(admm_epoch_kernel, epoch_len=epoch_len,
                                   alpha=1.6, interpret=interpret)))
    times = {}
    outs = {}
    for name, f in (("xla", xla), ("kernel", ker)):
        outs[name] = jax.block_until_ready(f(data, z0, w, y))
        t0 = time.perf_counter()
        jax.block_until_ready(f(data, z0, w, y))
        times[name] = time.perf_counter() - t0
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(outs["xla"], outs["kernel"]))
    return err, times


@contextlib.contextmanager
def forced_epoch(route: str):
    """Trace ``admm_solve`` with its epochs on one route: ``"kernel"``
    leaves it as it is (the GPU kernel on a GPU), ``"xla"`` takes the XLA
    epoch as other platforms do, and ``"interpret"`` takes the GPU kernel
    in the Pallas interpreter, whatever the platform (CPU tests)."""
    import jax
    from colaborativempc_tpu.ops import admm, admm_kernel
    saved = (admm.use_epoch_kernel, admm_kernel.admm_epoch_kernel,
             jax.lax.platform_dependent)
    if route == "xla":
        admm.use_epoch_kernel = lambda dtype, assoc: False
    elif route == "interpret":
        admm_kernel.admm_epoch_kernel = partial(saved[1], interpret=True)
        jax.lax.platform_dependent = (
            lambda *args, cuda, default, **_: cuda(*args))
    elif route != "kernel":
        raise ValueError(route)
    try:
        yield
    finally:
        (admm.use_epoch_kernel, admm_kernel.admm_epoch_kernel,
         jax.lax.platform_dependent) = saved


def random_stage_qp(rng, B: int, N: int, nz: int = 11, nc: int = 2,
                    m: int = 6):
    """``B`` feasible stage QPs (ops/admm.py StageQP) at the fleet stage
    width whose constraints bind: each row's bounds lie 0.02-0.2 around a
    random feasible trajectory; row 0 is one-sided, row 1 soft (weight
    50) and the last row unbounded (inactive)."""
    import jax.numpy as jnp
    from colaborativempc_tpu.ops.admm import StageQP
    from colaborativempc_tpu.ops.lqr import LQRCost, LQRDynamics
    p = stable_lqr_batch(rng, B, 1, N, nz, nc)
    z0 = p["z0"][:, 0]
    c_ref = rng.normal(size=(B, N, nc)) * 0.3
    z = [z0]
    for k in range(N):
        z.append(np.einsum("bij,bj->bi", p["F"][:, k], z[-1])
                 + np.einsum("bij,bj->bi", p["G"][:, k], c_ref[:, k])
                 + p["d"][:, k])
    z_ref = np.stack(z[:N], axis=1)
    D = rng.normal(size=(B, N, m, nz)) * 0.3
    E = rng.normal(size=(B, N, m, nc)) * 0.3
    v = (np.einsum("bkmi,bki->bkm", D, z_ref)
         + np.einsum("bkmi,bki->bkm", E, c_ref))
    lo = v - rng.uniform(0.02, 0.2, size=v.shape)
    hi = v + rng.uniform(0.02, 0.2, size=v.shape)
    lo[..., 0] = -np.inf
    lo[..., -1], hi[..., -1] = -np.inf, np.inf
    soft = np.full(v.shape, np.inf)
    soft[..., 1] = 50.0
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    qp = StageQP(
        dyn=LQRDynamics(f32(p["F"]), f32(p["G"]), f32(p["d"])),
        cost=LQRCost(f32(p["Q"]), f32(p["q"][:, 0]), f32(p["R"]),
                     f32(p["r"][:, 0]), f32(p["S"])),
        D=f32(D), E=f32(E), lo=f32(lo), hi=f32(hi), soft_lo=f32(soft),
        soft_hi=f32(soft))
    return qp, f32(z0)


def admm_solve_vs_xla(rng, B: int, N: int, route: str = "kernel",
                      iters: int = 600) -> dict:
    """Whole ``admm_solve`` runs (while_loop, adaptive rho, vmapped over
    ``B`` problems) with the epochs on ``route`` against the same solves on
    the XLA epoch, at the default eps=1e-4, and both against the float64
    XLA solve on this process's CPU device. Problems whose iteration counts
    differ (an exit test falling the other way) are counted, not compared.
    For the others, z, c, w and the multipliers rho * rho_scale * y are
    compared, each relative to its largest value. (The scaled dual y
    itself is not: the rho rescale divides it by a ratio of residuals near
    eps, which roundoff moves while the multiplier stays put.)"""
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.ops.admm import admm_solve
    from colaborativempc_tpu.utils.precision import x64_island
    qp, z0 = random_stage_qp(rng, B, N)
    rho = 10.0                                  # admm_solve's default

    def solve():                # a new function each time: a fresh trace
        return jax.jit(jax.vmap(lambda qp, z0: admm_solve(qp, z0,
                                                          iters=iters)))

    out = {}
    for name in ("xla", route):
        with forced_epoch(name):
            f = solve()
            sol = jax.block_until_ready(f(qp, z0))
            t0 = time.perf_counter()
            jax.block_until_ready(f(qp, z0))
            out[name] = (jax.device_get(sol), time.perf_counter() - t0)
    with x64_island(), jax.default_device(jax.devices("cpu")[0]):
        out["f64"] = (jax.device_get(solve()(*jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), (qp, z0)))),
            0.0)
    (ref, t_ref), (sol, t_sol) = out["xla"], out[route]

    def fields(s):
        return dict(z=s.z, c=s.c, w=s.w, lam=rho * np.asarray(
            s.rho_scale)[:, None, :] * np.asarray(s.y))

    def rel(a, b):
        """Largest relative difference per field over the problems whose
        iteration counts agree."""
        same = np.asarray(a.iterations) == np.asarray(b.iterations)
        fa, fb = fields(a), fields(b)
        return {k: float(np.abs(np.asarray(fa[k], np.float64)[same]
                                - np.asarray(fb[k], np.float64)[same])
                         .max(initial=0.0))
                / max(float(np.abs(np.asarray(fa[k])).max()), 1e-6)
                for k in fa}, int((~same).sum())

    errs, differing = rel(ref, sol)
    f64 = out["f64"][0]
    return dict(rel_err=max(errs.values()), differing_counts=differing,
                per_field={k: float(f"{v:.3g}") for k, v in errs.items()},
                xla_vs_f64=max(rel(f64, ref)[0].values()),
                route_vs_f64=max(rel(f64, sol)[0].values()),
                feasible_xla=float(np.mean(ref.feasible)),
                feasible=float(np.mean(sol.feasible)),
                iters_mean=float(np.mean(ref.iterations)),
                rho_scale_max=float(np.max(ref.rho_scale)),
                xla_ms=t_ref * 1e3, route_ms=t_sol * 1e3)


def lpv_steps_vs_f64(steps: int = 20, N: int = 125,
                     n_agents: int = 3) -> dict:
    """The first ``steps`` control steps of the ``lpv`` phase's float32
    loop on the default device, each repeated from the same fleet state in
    float64 on this process's CPU device. Per step this is one solve's own
    error; nothing carries over from step to step. Returns the largest
    differences of the executed states, applied inputs and plans, and the
    float32 executed states."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime import init_lpv_fleet, make_lpv_fleet_step
    from colaborativempc_tpu.runtime.simulate import (
        resolve_single_fleet_schedule)
    from colaborativempc_tpu.utils.precision import x64_island
    cfg = resolve_single_fleet_schedule(lpv_config(steps, N, n_agents))
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    track = make_track(cfg.map_type)
    step32 = make_lpv_fleet_step(track, cfg)
    state = init_lpv_fleet(track, cfg)
    cpu = jax.devices("cpu")[0]
    with x64_island(), jax.default_device(cpu):
        step64 = make_lpv_fleet_step(
            make_track(cfg.map_type, dtype=jnp.float64), cfg64)

    def to64(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if a.dtype.kind == "f" else None)

    err = dict(state=0.0, input=0.0, plan=0.0)
    states = []
    for _ in range(steps):
        nxt, _ = step32(state)
        with x64_island(), jax.default_device(cpu):
            ref, _ = jax.device_get(step64(jax.tree.map(to64, state)))
        for key, field in (("state", "x0"), ("input", "u_old"),
                           ("plan", "x_pred")):
            err[key] = max(err[key], float(np.abs(
                np.asarray(getattr(nxt, field), np.float64)
                - getattr(ref, field)).max()))
        state = nxt
        states.append(np.asarray(nxt.x0))
    err["states"] = np.asarray(states)
    return err


def closed_loop_vs_f64(states32, steps: int = 20, N: int = 125,
                       n_agents: int = 3) -> np.ndarray:
    """Largest difference per state component between the first ``steps``
    executed states of the float32 ``lpv`` loop and the same loop in
    float64 on this process's CPU device."""
    import dataclasses
    import jax
    from colaborativempc_tpu.runtime import run_lpv_experiment
    cfg = dataclasses.replace(lpv_config(steps, N, n_agents),
                              dtype="float64")
    with jax.default_device(jax.devices("cpu")[0]):
        res64 = run_lpv_experiment(cfg)
    check(res64.steps == steps, f"float64 loop ran {res64.steps} steps")
    return np.abs(np.asarray(states32[:steps], np.float64)
                  - res64.states).max(axis=(0, 1))


def phase_reference(res_lpv, n_mat: int = 16, per_mat: int = 48,
                    N: int = 125, kernel_B: int = 768, kernel_N: int = 20,
                    loop_steps: int = 20, loop_N: int = 125,
                    n_agents: int = 3, interpret: bool = False):
    rng = np.random.default_rng(0)
    prob = stable_lqr_batch(rng, n_mat, per_mat, N)
    for assoc in (False, True):
        err = riccati_vs_dense(prob, assoc)
        say("reference", check="riccati_vs_dense_kkt", assoc=assoc,
            problems=n_mat * per_mat, N=N, rel_err=err, tol=RICCATI_TOL)
        check(err < RICCATI_TOL, f"Riccati (assoc={assoc}) vs dense KKT: "
              f"{err} >= {RICCATI_TOL}")
    err, times = kernel_vs_xla(rng, kernel_B, kernel_N, interpret=interpret)
    say("reference", check="epoch_kernel_vs_xla", problems=kernel_B,
        N=kernel_N, max_err=err, tol=KERNEL_TOL,
        xla_epoch_ms=times["xla"] * 1e3,
        kernel_epoch_ms=times["kernel"] * 1e3)
    check(err < KERNEL_TOL, f"epoch kernel vs XLA: {err} >= {KERNEL_TOL}")

    r = admm_solve_vs_xla(rng, kernel_B, kernel_N,
                          route="interpret" if interpret else "kernel")
    primal = max(r["per_field"][k] for k in ("z", "c", "w"))
    say("reference", check="admm_solve_kernel_vs_xla", problems=kernel_B,
        N=kernel_N, primal_tol=ADMM_PRIMAL_TOL, dual_tol=ADMM_DUAL_TOL,
        max_differing_counts=kernel_B // 20, **r)
    check(primal < ADMM_PRIMAL_TOL
          and r["per_field"]["lam"] < ADMM_DUAL_TOL
          and r["differing_counts"] <= kernel_B // 20
          and r["feasible"] == r["feasible_xla"] and r["feasible"] > 0.9,
          f"admm_solve with the kernel vs XLA: {r}")

    steps = lpv_steps_vs_f64(loop_steps, loop_N, n_agents)
    replay = float(np.abs(steps["states"]
                          - res_lpv.states[:loop_steps]).max())
    say("reference", check="lpv_steps_f32_vs_f64_cpu", steps=loop_steps,
        state_err=steps["state"], input_err=steps["input"],
        plan_err=steps["plan"], tol=STEP_TOL,
        replay_vs_lpv_phase=replay)
    check(steps["state"] < STEP_TOL and steps["input"] < STEP_TOL,
          f"one step f32 vs f64: {steps}")

    diff = closed_loop_vs_f64(res_lpv.states, loop_steps, loop_N, n_agents)
    err = float(diff[list(POSITION_STATES)].max())
    say("reference", check="closed_loop_f32_vs_f64_cpu", steps=loop_steps,
        position_err_m=err, tol=CLOSED_LOOP_TOL,
        per_state=np.array2string(diff, precision=4))
    check(err < CLOSED_LOOP_TOL,
          f"closed loop f32 vs f64: {err} >= {CLOSED_LOOP_TOL}")


# ------------------------------------------------------------ four cards


def _shards_on(arr, n: int) -> int:
    devs = {s.device for s in arr.addressable_shards}
    check(len(devs) == n, f"state lies on {len(devs)} devices, not {n}")
    return len(devs)


def lockstep(name, n, steps, sharded, state, ref, **kv):
    """Run a sharded one-step rollout for ``steps`` control steps and, at
    every step, its one-card twin ``ref`` from the same state; compare the
    full executed states and plans. Each step starts from the sharded
    state, so each comparison is one step's own difference, not a drift
    carried through the loop."""
    import jax
    t0 = time.perf_counter()
    err = dict(first=0.0, state=0.0, plan=0.0)
    for k in range(steps):
        host = jax.device_get(state)
        state, _ = sharded(state)
        out, _ = ref(host)
        for key, f in (("state", "x0"), ("plan", "x_pred")):
            err[key] = max(err[key], float(np.abs(
                np.asarray(getattr(state, f))
                - np.asarray(getattr(out, f))).max()))
        if k == 0:
            err["first"] = max(err["state"], err["plan"])
    say("four", check=name, devices=_shards_on(state.x0, n),
        scenarios=state.x0.shape[0], steps=steps, state_err=err["state"],
        plan_err=err["plan"], first_step_err=err["first"], tol=SHARD_TOL,
        seconds=time.perf_counter() - t0, **kv)
    check(err["state"] < SHARD_TOL and err["plan"] < SHARD_TOL,
          f"{name}: {err} >= {SHARD_TOL}")


def phase_four(devices, n_scen: int = 64, N: int = 20, steps: int = 10,
               hp_agents: int = 4):
    """The sharded paths behind ``cmpc-monte-carlo --mesh`` on four cards,
    each against the same program unsharded on the first card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from colaborativempc_tpu.config import (
        ExperimentConfig, lpv_gains, nl_gains, OCDConfig, SolverConfig)
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.parallel import (
        batch_fleet_state, make_sharded_lpv_rollout,
        make_sharded_nl_ocd_rollout, make_sharded_nl_ocd_step,
        place_ocd_batch, shard_fleet_state, shard_ocd_state)
    from colaborativempc_tpu.runtime import init_lpv_fleet
    from colaborativempc_tpu.runtime.ocd import (
        init_nl_fleet, make_nl_ocd_rollout, make_nl_ocd_step)
    from colaborativempc_tpu.runtime.simulate import make_lpv_fleet_rollout
    n = len(devices)
    track = make_track("Highway")
    rng = np.random.default_rng(0)
    scen_mesh = Mesh(np.array(devices).reshape(n, 1), ("scen", "agent"))

    def one_card(rollout):
        """The vmapped one-step rollout on the first card, returning
        (state, metrics) like the sharded one; metrics (S, 1, ...) ->
        (1, S, ...)."""
        f = jax.jit(jax.vmap(rollout))

        def run(st):
            with jax.default_device(devices[0]):
                st, (_, _, m) = f(st)
            return st, jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), m)
        return run

    # LPV: 64 perturbed scenarios x 3 agents; ADMM iterations per agent
    cfg = ExperimentConfig(n_agents=3, N=N, dt=0.025, map_type="Highway",
                           gains=lpv_gains(),
                           solver=SolverConfig(admm_iters=300))
    base = batch_fleet_state(init_lpv_fleet(track, cfg), n_scen)
    base = base._replace(x0=base.x0 + jnp.asarray(
        rng.normal(size=base.x0.shape) * 0.02, base.x0.dtype))
    lockstep("sharded_lpv_rollout_vs_one_card", n, steps,
             make_sharded_lpv_rollout(track, cfg, scen_mesh, 1),
             shard_fleet_state(base, scen_mesh),
             one_card(make_lpv_fleet_rollout(track, cfg, 1)))

    # NL-OCD (eu): the same 64 scenarios; OCD iterations per scenario
    cfg_nl = ExperimentConfig(
        n_agents=3, N=N, dt=0.02, map_type="Highway", coupling="eu",
        gains=nl_gains(), ocd=OCDConfig(max_it_ocd=50),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    one = init_nl_fleet(track, cfg_nl)
    nl_base = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (n_scen,) + a.shape), one)
    nl_base = nl_base._replace(x0=nl_base.x0 + jnp.asarray(
        rng.normal(size=nl_base.x0.shape) * 0.02, nl_base.x0.dtype))
    lockstep("sharded_nl_ocd_rollout_vs_one_card", n, max(2, steps // 2),
             make_sharded_nl_ocd_rollout(track, cfg_nl, scen_mesh, 1),
             place_ocd_batch(nl_base, scen_mesh),
             one_card(make_nl_ocd_rollout(track, cfg_nl, 1)))

    # hp_opt with the agents split over the cards: the plan exchange
    # crosses devices
    cfg_hp = ExperimentConfig(
        n_agents=hp_agents, N=N, dt=0.02, map_type="Highway",
        coupling="hp_opt", gains=nl_gains(), ocd=OCDConfig(max_it_ocd=10),
        solver=SolverConfig(admm_iters=150, sqp_iters=1))
    agent_mesh = Mesh(np.array(devices).reshape(1, n), ("scen", "agent"))
    hp_state = init_nl_fleet(track, cfg_hp)
    ref_step = make_nl_ocd_step(track, cfg_hp)

    def hp_ref(st):
        with jax.default_device(devices[0]):
            st, m = ref_step(jax.tree.map(lambda a: a[0], st))
        return jax.tree.map(lambda a: a[None], (st, m))

    lockstep("sharded_hp_opt_step_vs_one_card", n, 1,
             make_sharded_nl_ocd_step(track, cfg_hp, agent_mesh),
             shard_ocd_state(hp_state, 1, agent_mesh), hp_ref,
             agents=hp_agents)


# ------------------------------------------------------------------ main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1
    devices = require_gpu(count)
    card = card_line()
    dev = devices[0]
    print(f"card: {card}", flush=True)
    say("device", platform=dev.platform, kind=repr(dev.device_kind),
        count=len(devices))
    t_all = time.perf_counter()
    if args.four:
        phase_four(devices[:4])
    else:
        for name, fn in (("lpv", phase_lpv), ("nl", phase_nl),
                         ("batch", lambda: phase_batch(card=card)),
                         ("mpcc", phase_mpcc)):
            t0 = time.perf_counter()
            out = fn()
            if name == "lpv":
                res_lpv = out
            say(name, phase_seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        phase_reference(res_lpv)
        say("reference", phase_seconds=time.perf_counter() - t0)
    say("all", seconds=time.perf_counter() - t_all, card=repr(card))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
