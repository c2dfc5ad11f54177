"""Closed-loop robustness studies: full-course, perturbed starts, latency.

The reference validates its planners only on the canonical golden starts
(``planner/scripts/*_main.py`` with the x0 database); this CLI productises
the round-3/4 robustness methodology so the hard-window
behaviour (the Highway k=0.35 curve congestion), the stressed-start
boundary and the long-horizon latency schedule stay reproducible:

- ``full-course``: one flagship run to course completion (LPV or NL-OCD,
  any coupling), reporting bad steps (solves above the feasibility
  tolerance — held, not executed, when hold_on_infeasible), plan-hold
  counts, completion and latency percentiles.
- ``perturbed``: N jittered cold starts at the curve-2 entry (s ~ 15-16.5,
  the hardest region found in round 3) — the Monte-Carlo that exposed the
  jam the recovery escalation ladder (config hold_reset_k/hold_cold_k)
  was built to close.
- ``latency``: warm per-step latency percentiles for the single-fleet
  schedule.

Examples:
  cmpc-stress full-course --family nl-eu --n 125 --steps 700
  cmpc-stress perturbed --starts 8 --steps 550 --variant assoc
  cmpc-stress latency --family nl-eu --n 125 --steps 100
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from colaborativempc_tpu.scripts._common import setup_backend


def _mk_cfg(family: str, N: int, steps: int, admm_iters=None,
            assoc=None, eps=1e-4, hold=True, ladder=True,
            sep_filter=True, vx_pass=True):
    from colaborativempc_tpu.config import (
        ExperimentConfig, SolverConfig, OCDConfig, lpv_gains, nl_gains,
    )
    # sqp_iters=2 for the NL families: the reference's own runs converge
    # their OCD loop at ~4 iterations; a 3-deep SQP with 0.7 mixing keeps
    # the trajectory jittering just above the OCD atol and the loop runs to
    # its cap (measured: 12 vs 31 iterations at N=20) — 2 is the
    # cmpc-nl/monte-carlo default and the round-3 methodology.
    solver = SolverConfig(admm_iters=admm_iters, assoc=assoc, eps=eps,
                          sqp_iters=2 if family.startswith("nl") else 3)
    base = dict(N=N, n_agents=3, dt=0.025, map_type="Highway",
                max_it=steps, laps=1, hold_on_infeasible=hold,
                hold_reset_k=3 if ladder else None,
                hold_cold_k=6 if ladder else None,
                exec_sep_frac=0.7 if sep_filter else None,
                hold_vx_frac=0.6 if vx_pass else None,
                solver=solver)
    if family == "lpv":
        return ExperimentConfig(**base, gains=lpv_gains())
    coupling = {"nl-eu": "eu", "nl-hp": "hp", "nl-hp_opt": "hp_opt"}[family]
    return ExperimentConfig(**base, gains=nl_gains(), coupling=coupling,
                            ocd=OCDConfig(max_it_ocd=30))


def _run(family: str, cfg, x0s=None):
    from colaborativempc_tpu.runtime import run_lpv_experiment
    from colaborativempc_tpu.runtime.ocd import run_nl_experiment
    if family.startswith("nl"):
        return run_nl_experiment(cfg, x0s=x0s)
    return run_lpv_experiment(cfg, x0s=x0s)


def _report(name, cfg, res, t_wall):
    import jax
    from colaborativempc_tpu.geometry import make_track
    track = make_track(cfg.map_type)
    L = float(np.asarray(track.track_length)[cfg.lane])
    s_final = np.asarray(res.states[-1][:, 6]) if res.steps else np.zeros(3)
    feas = np.asarray(res.feasible)
    bad = int((~feas.all(axis=1)).sum())
    holds = bad if cfg.hold_on_infeasible else 0
    times = np.asarray(res.step_times)
    warm = times[3:] if len(times) > 6 else times
    iters = getattr(res, "iterations", None)
    beta = np.asarray(getattr(res, "exec_beta", np.ones((0, 0))))
    out = {
        "study": name,
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "steps": int(res.steps),
        "finished": bool(res.finished),
        "complete_all": bool(res.finished
                             and np.isfinite(s_final).all()
                             and (s_final >= 0.8 * L).all()),
        "s_final": [round(float(s), 2) for s in s_final],
        "bad_steps": bad,
        "held_steps": holds,
        "min_dist_exec": round(float(np.asarray(res.min_dist_exec).min()), 4)
        if res.steps else None,
        "p50_ms": round(float(np.percentile(warm, 50)) * 1e3, 1),
        "p95_ms": round(float(np.percentile(warm, 95)) * 1e3, 1),
        "max_ms": round(float(warm.max()) * 1e3, 1),
        "wall_s": round(t_wall, 1),
        # separation-filter activity: steps where any agent was braked
        "filter_steps": int((beta < 1.0).any(axis=1).sum())
        if beta.size else 0,
        "min_beta": round(float(beta.min()), 3) if beta.size else 1.0,
        "wall_steps": int(np.asarray(
            getattr(res, "wall_clip", np.zeros((0, 0)))).any(axis=1).sum())
        if np.asarray(getattr(res, "wall_clip", np.zeros((0, 0)))).size
        else 0,
    }
    if iters is not None and np.asarray(iters).size:
        it_arr = np.asarray(iters, float)
        out["it_mean"] = round(float(it_arr.mean()), 1)
        out["it_max"] = int(it_arr.max())
    print(json.dumps(out))
    return out


def full_course(args):
    cfg = _mk_cfg(args.family, args.n, args.steps,
                  assoc=None if args.variant == "auto"
                  else (args.variant == "assoc"),
                  hold=not args.no_hold, ladder=not args.no_ladder,
                  sep_filter=not args.no_filter,
                  vx_pass=not args.no_vxpass)
    t0 = time.time()
    res = _run(args.family, cfg)
    return _report(f"full-course/{args.family}/N={args.n}", cfg, res,
                   time.time() - t0)


def _perturbed_x0s(cfg, rng):
    from colaborativempc_tpu.config import x0_database
    x0s = np.asarray(x0_database(cfg.n_agents)).copy()
    x0s[:, 6] = 15.0 + rng.uniform(0.0, 1.5, size=cfg.n_agents)
    return x0s


def perturbed_batched(args, cfg):
    """All jittered starts as ONE vmapped scanned rollout (a (starts,)
    scenario batch of the full fixed-step closed loop) — the on-device
    form of the study: no host dispatch between steps, every start
    advances in parallel on the VPU lanes. Completion is evaluated
    post-hoc from the s-history (a lane completes when at some step one
    agent has crossed the lap length while all agents are finite and past
    0.8 L — NaNs after a completed lap on the open Highway do not undo
    it, matching the host loop's stop-at-finish semantics)."""
    import jax
    import jax.numpy as jnp
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime import init_lpv_fleet
    from colaborativempc_tpu.runtime.simulate import (
        make_lpv_fleet_rollout, resolve_single_fleet_schedule,
    )
    from colaborativempc_tpu.runtime.ocd import (
        init_nl_fleet, make_nl_ocd_rollout,
    )
    nl = args.family.startswith("nl")
    cfg = resolve_single_fleet_schedule(cfg)
    track = make_track(cfg.map_type)
    rng = np.random.default_rng(args.seed)
    # chunked scan: the rollout runs as ceil(steps/chunk) scanned
    # dispatches with the state carried between them — identical
    # trajectory, bounded per-dispatch runtime
    chunk = max(1, min(args.steps, args.chunk))
    n_chunks = -(-args.steps // chunk)
    if nl:
        lanes = [init_nl_fleet(track, cfg, x0s=_perturbed_x0s(cfg, rng))
                 for _ in range(args.starts)]
        roll = make_nl_ocd_rollout(track, cfg, chunk)
    else:
        lanes = [init_lpv_fleet(track, cfg, x0s=_perturbed_x0s(cfg, rng))
                 for _ in range(args.starts)]
        roll = make_lpv_fleet_rollout(track, cfg, chunk)
    state = jax.tree.map(lambda *xs: jnp.stack(xs), *lanes)
    batched = jax.jit(jax.vmap(roll))
    t0 = time.time()
    hists = []
    for _ in range(n_chunks):
        state, hist = jax.block_until_ready(batched(state))
        hists.append(hist)
    x0h, uh, m = jax.tree.map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=1),
        *hists)
    # trim the chunk-padded tail so a non-dividing --chunk reports
    # exactly --steps (metrics stay comparable to the host-loop study)
    x0h, uh = x0h[:, :args.steps], uh[:, :args.steps]
    m = jax.tree.map(lambda v: v[:, :args.steps], m)
    steps_run = min(n_chunks * chunk, args.steps)
    t_wall = time.time() - t0
    L = float(np.asarray(track.track_length)[cfg.lane])
    s = np.asarray(x0h[..., 6])                     # (S, steps, n_ag)
    finite = np.isfinite(np.asarray(x0h)).all(axis=(2, 3))  # (S, steps)
    done = (finite & (s.max(axis=2) >= L * cfg.laps)
            & (s.min(axis=2) >= 0.8 * L))           # (S, steps)
    complete = done.any(axis=1)
    t_done = np.where(complete, done.argmax(axis=1), steps_run)
    feas = np.asarray(m.feasible)                    # (S, steps, n_ag)
    alive = np.arange(steps_run)[None, :] <= t_done[:, None]
    held = ((~feas.all(axis=2)) & alive).sum(axis=1)
    mde = np.asarray(m.min_dist_exec)                # (S, steps)
    # mask non-finite rows (a diverged incomplete lane carries NaN) so
    # the min stays finite and the JSON stays strict-parser-valid
    mde = np.where(alive & np.isfinite(mde), mde, np.inf).min(axis=1)
    out = {
        "study": f"perturbed-batched/{args.family}/{args.variant}",
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "starts": args.starts, "steps": steps_run, "N": cfg.N,
        "chunk": chunk,
        "complete": int(complete.sum()),
        "t_complete": t_done.tolist(),
        "held_steps": held.tolist(),
        "min_dist_exec": [round(float(d), 4) if np.isfinite(d) else None
                          for d in mde],
        "filter_steps": np.asarray(
            (np.asarray(m.exec_beta) < 1.0).any(axis=2)
            & alive).sum(axis=1).tolist(),
        # honesty metric: worst lateral excursion while alive — an agent
        # ejected from the corridor can still "complete" by arc progress
        # (round-5 seq lane-7 study: one scrambled agent recovered along
        # the track but ~meters off the lane)
        "max_abs_ey": [round(float(e), 2) for e in np.where(
            alive[:, :, None], np.abs(np.asarray(x0h[..., 3])), 0.0)
            .max(axis=(1, 2))],
        "wall_steps": np.asarray(
            np.asarray(m.wall_clip).any(axis=2) & alive).sum(axis=1)
            .tolist(),
        "wall_s": round(t_wall, 1),
    }
    print(json.dumps(out))
    return out


def perturbed(args):
    """Jittered cold starts at the curve-2 entry (the round-3 stressed
    boundary): base x0 rows with s shifted to 15 + U(0, 1.5) per agent."""
    from colaborativempc_tpu.config import x0_database
    cfg = _mk_cfg(args.family, args.n, args.steps,
                  assoc=None if args.variant == "auto"
                  else (args.variant == "assoc"),
                  hold=not args.no_hold, ladder=not args.no_ladder,
                  sep_filter=not args.no_filter,
                  vx_pass=not args.no_vxpass)
    if args.batched:
        return perturbed_batched(args, cfg)
    rng = np.random.default_rng(args.seed)
    n_complete = 0
    rows = []
    for k in range(args.starts):
        x0s = np.asarray(x0_database(cfg.n_agents)).copy()
        x0s[:, 6] = 15.0 + rng.uniform(0.0, 1.5, size=cfg.n_agents)
        t0 = time.time()
        res = _run(args.family, cfg, x0s=x0s)
        out = _report(
            f"perturbed[{k}]/{args.family}/{args.variant}", cfg, res,
            time.time() - t0)
        rows.append(out)
        n_complete += int(out["complete_all"])
    print(json.dumps({"study": f"perturbed/{args.family}/{args.variant}",
                      "complete": n_complete, "starts": args.starts,
                      "held_steps": [r["held_steps"] for r in rows]}))
    return rows


def latency(args):
    cfg = _mk_cfg(args.family, args.n, args.steps,
                  assoc=None if args.variant == "auto"
                  else (args.variant == "assoc"),
                  sep_filter=not args.no_filter,
                  vx_pass=not args.no_vxpass)
    cfg = dataclasses.replace(cfg, laps=10**6)  # fixed-step: pure latency
    t0 = time.time()
    res = _run(args.family, cfg)
    return _report(f"latency/{args.family}/N={args.n}/{args.variant}", cfg,
                   res, time.time() - t0)


def gs_tradeoff(args):
    """Jacobi vs Gauss-Seidel at batch: the measurement behind the
    parallel/ocd.py restriction (gauss_seidel raises on the agent-sharded
    mesh). GS serialises agents within a coordination iteration (an
    n_agents-deep scan of solves) but uses fresher neighbour data, so it
    needs fewer OCD iterations; Jacobi solves all agents as ONE vmapped
    batch. Whether GS's iteration savings pay for its serialisation is an
    empirical question per shape — this prints both sides: mean OCD
    iterations and wall time per control step over a vmapped scenario
    batch.
    """
    import jax
    import dataclasses as dc
    from colaborativempc_tpu.config import OCDConfig
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime.ocd import (
        init_nl_fleet, make_nl_ocd_rollout_gains,
    )
    from colaborativempc_tpu.config import nl_gains
    import jax.numpy as jnp

    steps = args.steps
    B = args.batch
    for sweep in ("jacobi", "gauss_seidel"):
        cfg = _mk_cfg(args.family if args.family.startswith("nl")
                      else "nl-eu", args.n, steps)
        cfg = dc.replace(cfg, ocd=OCDConfig(max_it_ocd=30, sweep=sweep))
        track = make_track(cfg.map_type)
        rollout = make_nl_ocd_rollout_gains(track, cfg, steps)
        sweep_fn = jax.jit(jax.vmap(rollout, in_axes=(None, 0)))
        state = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (B,) + x.shape).copy(),
            init_nl_fleet(track, cfg))
        gains = cfg.gains if cfg.gains is not None else nl_gains()
        # compile + warm
        out = jax.block_until_ready(sweep_fn(gains, state))
        t0 = time.time()
        reps = max(args.reps, 1)
        for _ in range(reps):
            final, (x0h, uh, m) = jax.block_until_ready(
                sweep_fn(gains, state))
        dt_step = (time.time() - t0) / (reps * steps)
        iters = np.asarray(m.ocd_iterations, float)
        print(json.dumps({
            "study": f"gs-tradeoff/{sweep}",
            "batch": B, "steps": steps, "N": args.n,
            "ocd_iters_mean": round(float(iters.mean()), 2),
            "ms_per_fleet_step_batch": round(dt_step * 1e3, 1),
            "fleet_steps_per_s": round(B / dt_step, 1),
            "feasible": bool(np.asarray(m.feasible).all()),
        }))


def main(argv=None):
    setup_backend()
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--family", default="lpv",
                       choices=["lpv", "nl-eu", "nl-hp", "nl-hp_opt"])
        p.add_argument("--n", type=int, default=125, help="horizon N")
        p.add_argument("--variant", default="auto",
                       choices=["auto", "assoc", "seq"],
                       help="Riccati path (auto = the resolved schedule)")
        p.add_argument("--no-hold", action="store_true",
                       help="disable hold_on_infeasible (raw semantics)")
        p.add_argument("--no-ladder", action="store_true",
                       help="disable the recovery escalation ladder")
        p.add_argument("--no-filter", action="store_true",
                       help="disable the executed-separation safety "
                            "filter (exec_sep_frac=None)")
        p.add_argument("--no-vxpass", action="store_true",
                       help="disable the hold-recovery vx_ref "
                            "feasibility pass (hold_vx_frac=None)")

    p = sub.add_parser("full-course")
    common(p)
    p.add_argument("--steps", type=int, default=700)
    p.set_defaults(fn=full_course)

    p = sub.add_parser("perturbed")
    common(p)
    p.add_argument("--steps", type=int, default=550)
    p.add_argument("--starts", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=50,
                   help="scan chunk length per device dispatch (batched)")
    p.add_argument("--batched", action="store_true",
                   help="all starts as one vmapped scanned rollout "
                        "(one device program; no per-run latency rows)")
    p.set_defaults(fn=perturbed)

    p = sub.add_parser("latency")
    common(p)
    p.add_argument("--steps", type=int, default=100)
    p.set_defaults(fn=latency)

    p = sub.add_parser("gs-tradeoff")
    common(p)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=gs_tradeoff)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
