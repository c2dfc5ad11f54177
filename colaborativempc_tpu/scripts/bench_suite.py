#!/usr/bin/env python
"""Benchmark suite over the BASELINE.json configurations.

Prints one JSON line per configuration, each with the device it ran on
(bench.py stays the single-line headline benchmark). Runs on the default
JAX device, or on the host with --cpu.

    python scripts/bench_suite.py [--quick]
"""

import argparse
import json
import time

from colaborativempc_tpu.scripts._common import setup_backend
setup_backend()

import numpy as np


def timeit(fn, *args, reps=10):
    """Median wall time of ``reps`` calls after a compiling one, each call
    blocked until the device is done."""
    import jax
    out = jax.block_until_ready(fn(*args))   # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def device_kind():
    import jax
    return jax.devices()[0].device_kind


def fleet_bench(name, n_agents, N, B, steps_warm=3, admm_iters=300,
                map_type="Highway", eps=1e-4):
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.config import (
        ExperimentConfig, lpv_gains, SolverConfig,
    )
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime import init_lpv_fleet
    from colaborativempc_tpu.runtime.simulate import make_lpv_fleet_step
    from colaborativempc_tpu.parallel import batch_fleet_state

    cfg = ExperimentConfig(
        n_agents=n_agents, N=N, dt=0.02, map_type=map_type,
        gains=lpv_gains(),
        solver=SolverConfig(admm_iters=admm_iters, eps=eps))
    track = make_track(cfg.map_type)
    state = batch_fleet_state(init_lpv_fleet(track, cfg), B)
    rng = np.random.default_rng(0)
    state = state._replace(x0=state.x0 + jnp.asarray(
        rng.normal(size=state.x0.shape) * 0.02, state.x0.dtype))
    step = jax.jit(jax.vmap(make_lpv_fleet_step(track, cfg)))
    for _ in range(steps_warm):          # reach warm-started steady state
        state, _ = step(state)
    dt_step, (state, metrics) = timeit(lambda s: step(s), state)
    solves = B * n_agents / dt_step
    print(json.dumps({
        "config": name, "agents": n_agents, "N": N, "batch": B,
        "ms_per_step": round(dt_step * 1e3, 2),
        "solves_per_sec": round(solves, 1),
        "feasible": bool(np.asarray(metrics.feasible).all()),
        "device": device_kind(),
        "protocol": "median-of-10",
    }), flush=True)


def nl_fleet_bench(name, n_agents, N, B, steps_warm=2):
    """Batched NL-OCD throughput: B scenarios of the full coordination
    loop (SQP solves + dual ascent + per-scenario convergence) advance per
    step — the reference's headline algorithm, which it runs one fleet at
    a time at ~0.36 s per OCD iteration (BASELINE.md)."""
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.config import (
        ExperimentConfig, nl_gains, SolverConfig, OCDConfig,
    )
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime.ocd import (
        init_nl_fleet, make_nl_ocd_step,
    )

    cfg = ExperimentConfig(
        n_agents=n_agents, N=N, dt=0.02, map_type="Highway",
        gains=nl_gains(), ocd=OCDConfig(max_it_ocd=30),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    track = make_track(cfg.map_type)
    state = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (B,) + x.shape).copy(),
        init_nl_fleet(track, cfg))
    rng = np.random.default_rng(0)
    dx = rng.normal(size=state.x0.shape) * 0.02
    dx[..., 3:] = 0.0
    state = state._replace(x0=state.x0 + jnp.asarray(dx, state.x0.dtype))
    step = jax.jit(jax.vmap(make_nl_ocd_step(track, cfg)))
    for _ in range(steps_warm):
        state, m = step(state)
    dt_step, (state, m) = timeit(lambda s: step(s), state)
    its = np.asarray(m.ocd_iterations)
    print(json.dumps({
        "config": name, "agents": n_agents, "N": N, "batch": B,
        "ms_per_step": round(dt_step * 1e3, 2),
        "fleet_steps_per_sec": round(B / dt_step, 1),
        "ocd_it_mean": round(float(its.mean()), 1),
        "feasible": bool(np.asarray(m.feasible).all()),
        "device": device_kind(),
        "protocol": "median-of-10",
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test shapes (test suite / CI)")
    ap.add_argument("--saturation", action="store_true",
                    help="batch-saturation study: solves/s vs batch for the "
                    "headline and N=125 shapes")
    ap.add_argument("--batches", default="64,128,256,512,1024",
                    help="batch sizes for --saturation")
    args = ap.parse_args()

    if args.tiny:
        fleet_bench("tiny LPV smoke", 2, 8, 4, admm_iters=100)
        nl_fleet_bench("tiny NL smoke", 2, 8, 2)
        return

    if args.saturation:
        for B in [int(b) for b in args.batches.split(",")]:
            fleet_bench(f"headline 3-agent H=20 B={B}", 3, 20, B)
        for B in [int(b) for b in args.batches.split(",")]:
            if B > 512:
                continue  # N=125 at B>512 exceeds sane HBM working sets
            fleet_bench(f"long-horizon 3-agent N=125 B={B}", 3, 125, B,
                        admm_iters=600, eps=5e-4)
        return

    # BASELINE.json configs, scaled to one device
    fleet_bench("1-agent LPV H=10 oval", 1, 10, 256, map_type="oval")
    fleet_bench("1-agent H=20 constrained warm", 1, 20, 256)
    fleet_bench("2-agent collaborative", 2, 20, 128)
    fleet_bench("8-agent shared lane", 8, 20, 32)
    if not args.quick:
        fleet_bench("16 agents x 64 scenarios (monte-carlo)", 16, 20, 64)
        # eps=5e-4: still 2x tighter than the reference's own solver
        # tolerance (OSQP default eps_abs=1e-3, LPV_Planner.py:222-239);
        # the batch pays the slowest problem's iterations, and the last
        # sub-5e-4 digit of a residual tail costs ~2x wall time.
        # THROUGHPUT-ONLY setting: closed-loop full courses need eps=1e-4
        # — at 5e-4 the executed-plan error compounds through the Highway
        # hard window until the fleet deadlocks (full-course study);
        # run_lpv_experiment keeps the 1e-4 default.
        fleet_bench("3-agent long horizon N=125", 3, 125, 64,
                    admm_iters=600, eps=5e-4)
        nl_fleet_bench("3-agent NL-OCD Monte-Carlo", 3, 20, 64)


if __name__ == "__main__":
    main()
