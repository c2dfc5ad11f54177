#!/usr/bin/env python
"""MPCC closed-loop racing experiment (the reference's native sim entry,
``Matlab-tests/MPCC-master/C++/main.cpp:30-86``, as a CLI like every other
planner family).

    python scripts/mpcc_main.py [--config Params/config.json]
                                [--map oval_mt | --track-json track.json]
                                [--N 20] [--steps 400] [--laps 1]
                                [--out data/mpcc] [--no-normalize]

``--config`` accepts BOTH the reference's master ``config.json`` layout
(model/cost/bounds/track sub-files) and this framework's flat JSON schema
(planners/mpcc.py mpcc_config_from_json).
"""

import argparse
import dataclasses

from colaborativempc_tpu.scripts._common import plotting, setup_backend
setup_backend()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="JSON config (reference master layout or flat)")
    ap.add_argument("--map", default=None, help="named analytic track")
    ap.add_argument("--track-json", default=None,
                    help="reference-format track JSON to fit and race")
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None, help="n_sim")
    ap.add_argument("--laps", type=int, default=None,
                    help="terminate after this many laps (0 = run n_sim)")
    ap.add_argument("--sqp", type=int, default=None, help="n_sqp")
    ap.add_argument("--no-normalize", action="store_true",
                    help="solve in raw variables (skip the reference's "
                    "T_x/T_u normalisation, params.h:31-58)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--verb", type=int, default=1)
    args = ap.parse_args()

    from colaborativempc_tpu.planners.mpcc import (
        MPCCConfig, mpcc_config_from_json,
    )
    from colaborativempc_tpu.runtime.racing import (
        run_mpcc_experiment, load_mpcc_track,
    )

    cfg = (mpcc_config_from_json(args.config) if args.config
           else MPCCConfig())
    over = {}
    if args.map is not None:
        over.update(map_type=args.map, track_json=None)
    if args.track_json is not None:
        over["track_json"] = args.track_json
    if args.N is not None:
        over["N"] = args.N
    if args.dt is not None:
        over["dt"] = args.dt
    if args.steps is not None:
        over["n_sim"] = args.steps
    if args.laps is not None:
        over["laps"] = args.laps
    if args.sqp is not None:
        over["n_sqp"] = args.sqp
    if args.no_normalize:
        over["normalize"] = False
    if args.out is not None:
        over["path"] = args.out
    if args.save:
        over["save_data"] = True
    over["verb"] = args.verb
    cfg = dataclasses.replace(cfg, **over)

    track = load_mpcc_track(cfg)
    res = run_mpcc_experiment(cfg, track=track)

    if args.plot:
        mod = plotting()
        if mod is not None:
            mod.plot_experiment(track, res.states[:, None, :], path=cfg.path)
    warm = res.step_times[3:] if len(res.step_times) > 3 else res.step_times
    lap = f" lap_time={res.lap_time:.2f}s" if res.lap_time else ""
    print(f"steps={res.steps} finished={res.finished} "
          f"s={res.states[-1, 6]:.2f} vx_mean={res.states[:, 0].mean():.2f} "
          f"feasible={res.feasible.mean() * 100:.0f}% "
          f"resets={int(res.resets.sum())}{lap} "
          f"mean_step={np.mean(warm) * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
