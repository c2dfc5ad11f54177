#!/usr/bin/env python
"""Distributed NL-OCD collaborative-MPC experiment (reference
``planner/scripts/NL_EU_N_main.py`` / ``NL_HP_N_main.py`` with
``config_files/config_NL.py``).

    python scripts/nl_main.py [--coupling eu|hp] [--agents 3] [--N 20]
                              [--steps 1500] [--out data/NL_3agents]
                              [--lambdas data/NL_3agents/pck/ini_lambdas.pkl]
"""

import argparse
import os
import sys

from colaborativempc_tpu.scripts._common import save_figures, setup_backend
setup_backend()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coupling", choices=["eu", "hp", "hp_opt"],
                    default="eu")
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--dt", type=float, default=0.02)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--out", default=None)
    ap.add_argument("--lambdas", default=None,
                    help="ini_lambdas.pkl warm start")
    ap.add_argument("--verb", type=int, default=1)
    ap.add_argument("--verb-ocd", action="store_true",
                    help="host-driven coordination loop with true "
                    "per-iteration timings (reference verb_OCD; slower)")
    ap.add_argument("--sweep", choices=["jacobi", "gauss_seidel"],
                    default="jacobi",
                    help="coordination sweep order (gauss_seidel = agents "
                    "use freshest neighbour plans, the reference ROS "
                    "mode's asynchrony made deterministic)")
    ap.add_argument("--lane", type=int, default=0)
    ap.add_argument("--dynamic-lane", action="store_true",
                    help="per-step lane re-selection on multi-lane tracks "
                    "(reference set_lane/checkLane)")
    args = ap.parse_args()
    out = args.out or f"data/NL_{args.agents}agents_{args.coupling}"

    from colaborativempc_tpu.config import (
        ExperimentConfig, nl_gains, SolverConfig, OCDConfig,
    )
    from colaborativempc_tpu.runtime import (
        run_nl_experiment, ExperimentIO, load_lambdas,
    )

    cfg = ExperimentConfig(
        n_agents=args.agents, N=args.N, dt=args.dt, max_it=args.steps,
        map_type=args.map, coupling=args.coupling, gains=nl_gains(),
        path=out, verb=args.verb, verb_ocd=args.verb_ocd,
        lane=args.lane, dynamic_lane=args.dynamic_lane,
        ocd=OCDConfig(max_it_ocd=50, sweep=args.sweep),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    lam0 = (load_lambdas(args.lambdas, args.agents, args.N)
            if args.lambdas else None)
    io = ExperimentIO(cfg)
    res = run_nl_experiment(cfg, lambdas0=lam0, io=io)
    io.save_all(lambdas=res.lambdas)

    save_figures(cfg.map_type, res.states, cfg.dt, out)
    print(f"steps={res.steps} finished={res.finished} "
          f"feasible={res.feasible.all()} "
          f"OCD mean={res.ocd_iterations.mean():.1f} "
          f"min_dist_exec={res.min_dist_exec.min():.3f} "
          f"mean_step={np.mean(res.step_times[3:] if len(res.step_times) > 3 else res.step_times) * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
