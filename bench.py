"""Batched collaborative-MPC solves/s on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

Workload: the collaborative LPV-MPC fleet step (3 agents, H=20, Highway —
the reference's NL experiment shape, config_NL.py:20-22) batched over
perturbed scenarios. Each fleet step performs one full MPC solve per agent
(plane generation, LPV stage-QP assembly, Riccati+ADMM). The batch of 256
was chosen on another accelerator and awaits re-measurement on the H100.

Baseline: the reference solves one agent-step in 0.11-0.13 s on an
i7-13700H (BASELINE.md, LPV3r_agent_laptop time.dat) => ~9.1 solves/s/core.

    python bench.py
"""

import json
import time

import numpy as np

N_SCEN = 256
N_AGENTS = 3
H = 20
STEPS = 20


def build(n_scen=N_SCEN, n_agents=N_AGENTS, horizon=H, steps=STEPS, seed=0):
    """The scanned batch rollout and its perturbed initial state:
    ``jax.jit(jax.vmap(make_lpv_fleet_rollout(...)))`` over ``n_scen``
    scenarios, ``steps`` control steps as ONE device program."""
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.config import (
        ExperimentConfig, lpv_gains, SolverConfig,
    )
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime import init_lpv_fleet
    from colaborativempc_tpu.runtime.simulate import make_lpv_fleet_rollout
    from colaborativempc_tpu.parallel import batch_fleet_state

    cfg = ExperimentConfig(
        n_agents=n_agents, N=horizon, dt=0.02, map_type="Highway",
        gains=lpv_gains(), solver=SolverConfig(admm_iters=300))
    track = make_track(cfg.map_type)
    state = batch_fleet_state(init_lpv_fleet(track, cfg), n_scen)
    # perturb scenarios so the batch is not degenerate
    rng = np.random.default_rng(seed)
    dx = jnp.asarray(rng.normal(size=state.x0.shape) * 0.02, state.x0.dtype)
    state = state._replace(x0=state.x0 + dx)
    rollout = jax.jit(jax.vmap(make_lpv_fleet_rollout(track, cfg, steps)))
    return rollout, state


def main():
    import jax
    dev = jax.devices()[0]
    rollout, state = build()
    state, _ = jax.block_until_ready(rollout(state))   # compile + warm
    t0 = time.perf_counter()
    state, _ = jax.block_until_ready(rollout(state))
    dt_step = (time.perf_counter() - t0) / STEPS
    solves_per_sec = N_SCEN * N_AGENTS / dt_step
    baseline = 9.1  # reference solves/s/core (0.11 s/agent-solve)
    print(json.dumps({
        "metric": f"batched collaborative MPC solves/s (H={H}, "
                  f"{N_AGENTS} agents, {N_SCEN} scenarios)",
        "value": solves_per_sec,
        "unit": "solves/s",
        "vs_baseline": solves_per_sec / baseline,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
