#!/usr/bin/env python
"""Decentralised LPV collaborative-MPC experiment (reference
``planner/scripts/LPV_HP_N_main.py`` with ``config_files/config_LPV.py``).

Runs the reference's flagship LPV configuration — 3 agents, N=125,
dt=0.025, Highway — saves the reference on-disk schema, and figures
where matplotlib is installed.

    python scripts/lpv_main.py [--agents 3] [--N 125] [--steps 600]
                               [--map Highway] [--out data/LPV3r]
"""

import argparse
import sys
import os

from colaborativempc_tpu.scripts._common import save_figures, setup_backend
setup_backend()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--N", type=int, default=125)
    ap.add_argument("--dt", type=float, default=0.025)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--out", default="data/LPV3r")
    ap.add_argument("--verb", type=int, default=1)
    ap.add_argument("--admm-iters", type=int, default=1000)
    args = ap.parse_args()

    from colaborativempc_tpu.config import (
        ExperimentConfig, lpv_gains, SolverConfig,
    )
    from colaborativempc_tpu.runtime import run_lpv_experiment, ExperimentIO

    cfg = ExperimentConfig(
        n_agents=args.agents, N=args.N, dt=args.dt, max_it=args.steps,
        map_type=args.map, gains=lpv_gains(), path=args.out, verb=args.verb,
        solver=SolverConfig(admm_iters=args.admm_iters))
    io = ExperimentIO(cfg)
    res = run_lpv_experiment(cfg, io=io)
    io.save_all()

    save_figures(cfg.map_type, res.states, cfg.dt, args.out)
    print(f"steps={res.steps} finished={res.finished} "
          f"feasible={res.feasible.all()} "
          f"min_dist_exec={res.min_dist_exec.min():.3f} "
          f"mean_step={np.mean(res.step_times[3:] if len(res.step_times) > 3 else res.step_times) * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
