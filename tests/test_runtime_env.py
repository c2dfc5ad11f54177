"""Where the compile cache lands, matmul precision pins on the solve path,
and entry points that must not need matplotlib."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = """
import jax, jax.numpy as jnp
import colaborativempc_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
print(jax.config.jax_compilation_cache_dir)
if {compile}:
    jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.ones(7)).block_until_ready()
"""


def _probe(env_extra, compile_):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_ENABLE_COMPILATION_CACHE="true", **env_extra)
    p = subprocess.run([sys.executable, "-c",
                        _CACHE_PROBE.format(compile=compile_)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_cache_honours_jax_compilation_cache_dir(tmp_path):
    d = str(tmp_path / "cache")
    assert _probe({"JAX_COMPILATION_CACHE_DIR": d}, True) == d
    assert os.path.isdir(d) and os.listdir(d), "nothing was cached there"


def test_cache_defaults_to_fixed_path_in_checkout():
    got = _probe({}, False)
    assert got == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _dot_precisions(fn, *args):
    """Precision of every dot_general in the jaxpr of fn(*args)."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr if hasattr(sub.jaxpr, "eqns")
                             else sub.jaxpr.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _highest(prec):
    hi = jax.lax.Precision.HIGHEST
    return prec is not None and all(p == hi for p in (
        prec if isinstance(prec, tuple) else (prec,)))


def _site(name):
    """One solve-path site that used to hold an unpinned float32 product,
    as (fn, float64-capable args)."""
    from colaborativempc_tpu.config import ModelParams
    from colaborativempc_tpu.dynamics.bicycle import f_continuous
    from colaborativempc_tpu.dynamics.pacejka import (
        PacejkaParams, linearize_pacejka)
    rng = np.random.default_rng(0)
    x = np.array([1.2, 0.05, 0.1, 0.1, 0.02, 0.1, 1.0, 1.0, 0.5])
    u = np.array([0.05, 0.4])
    N = 6
    xs = x + rng.normal(size=(N + 1, 9)) * 0.01
    us = u + rng.normal(size=(N, 2)) * 0.01
    if name == "bicycle.f_continuous":
        return lambda x, u: f_continuous(x, u, 0.3, ModelParams()), (x, u)
    if name == "pacejka.linearize":
        return (lambda x, u: linearize_pacejka(x, u, 0.3, PacejkaParams(),
                                               0.02), (x, u))
    if name == "nl.linearize_horizon":
        from colaborativempc_tpu.planners.nl import _linearize_horizon
        return (lambda xs, us: _linearize_horizon(
            xs[:N], us, jnp.full((N,), 0.3, xs.dtype), 0.02, ModelParams()),
            (xs, us))
    if name == "lpv.violations":
        from colaborativempc_tpu.ops import StageQP, LQRCost, LQRDynamics
        from colaborativempc_tpu.planners.lpv import _violations
        m, nz, nc = 6, 11, 2
        D = rng.normal(size=(N, m, nz))
        E = rng.normal(size=(N, m, nc))
        lo = -np.abs(rng.normal(size=(N, m)))
        hi = np.abs(rng.normal(size=(N, m)))
        z = rng.normal(size=(N + 1, nz))
        c = rng.normal(size=(N, nc))

        def fn(D, E, lo, hi, z, c):
            zero = jnp.zeros((N, nz, nz), D.dtype)
            qp = StageQP(dyn=LQRDynamics(zero, E[:, :nz, :] * 0, z[:N]),
                         cost=LQRCost(zero, z, zero[:, :nc, :nc], c, zero[
                             :, :, :nc]), D=D, E=E, lo=lo, hi=hi)
            return _violations(qp, z, c)
        return fn, (D, E, lo, hi, z, c)
    if name == "mpcc.build_qp":
        from colaborativempc_tpu.geometry import make_track
        from colaborativempc_tpu.planners.mpcc import (
            MPCCGains, build_mpcc_qp)
        xs = xs.copy()
        xs[:, 6] = np.linspace(0.0, 0.3, N + 1)

        def fn(xs, us):
            track = make_track("oval_mt", dtype=xs.dtype)
            return build_mpcc_qp(track, MPCCGains(), PacejkaParams(), N,
                                 0.05, xs, us).hi
        return fn, (xs, us)
    raise KeyError(name)


SITES = ["bicycle.f_continuous", "pacejka.linearize", "nl.linearize_horizon",
         "lpv.violations", "mpcc.build_qp"]


@pytest.mark.parametrize("site", SITES)
def test_pinned_sites_match_float64(site):
    """Every product at the solve-path sites is pinned to
    Precision.HIGHEST (on the H100 an unpinned float32 product may run in
    TF32), and the float32 results agree with float64."""
    from colaborativempc_tpu.utils.precision import x64_island
    fn, args = _site(site)
    a32 = [jnp.asarray(a, jnp.float32) for a in args]
    precs = _dot_precisions(fn, *a32)
    assert precs and all(_highest(p) for p in precs), precs
    out32 = jax.tree.leaves(fn(*a32))
    with x64_island():
        out64 = [np.asarray(o) for o in jax.tree.leaves(
            fn(*[jnp.asarray(a, jnp.float64) for a in args]))]
    for o32, o64 in zip(out32, out64):
        assert o32.dtype == jnp.float32
        fin = np.isfinite(o64)
        np.testing.assert_allclose(np.asarray(o32)[fin], o64[fin],
                                   rtol=1e-4, atol=1e-4)


def _main_path(name):
    """A jitted step of one of chip_smoke.py's paths at a tiny size, and its
    argument."""
    import bench
    from colaborativempc_tpu.config import (
        ExperimentConfig, lpv_gains, nl_gains, OCDConfig, SolverConfig)
    from colaborativempc_tpu.geometry import make_track
    if name == "batch":
        return bench.build(n_scen=2, horizon=8, steps=2)
    if name == "mpcc":
        from colaborativempc_tpu.planners import MPCCConfig
        from colaborativempc_tpu.runtime.racing import (
            init_mpcc, make_mpcc_step)
        cfg = MPCCConfig(N=10, dt=0.05, map_type="oval_mt")
        track = make_track(cfg.map_type)
        return make_mpcc_step(track, cfg), init_mpcc(track, cfg)
    track = make_track("Highway")
    if name == "nl":
        from colaborativempc_tpu.runtime.ocd import (
            init_nl_fleet, make_nl_ocd_step)
        cfg = ExperimentConfig(
            n_agents=3, N=8, dt=0.02, map_type="Highway", coupling="eu",
            gains=nl_gains(), ocd=OCDConfig(max_it_ocd=5),
            solver=SolverConfig(admm_iters=40, sqp_iters=2))
        return make_nl_ocd_step(track, cfg), init_nl_fleet(track, cfg)
    from colaborativempc_tpu.runtime import init_lpv_fleet, make_lpv_fleet_step
    from colaborativempc_tpu.runtime.simulate import (
        resolve_single_fleet_schedule)
    # N=60 takes the single-fleet schedule (associative scan) like N=125
    cfg = resolve_single_fleet_schedule(ExperimentConfig(
        n_agents=3, N=60 if name == "lpv_long" else 12, dt=0.025,
        map_type="Highway", gains=lpv_gains()))
    return make_lpv_fleet_step(track, cfg), init_lpv_fleet(track, cfg)


@pytest.mark.parametrize("path", ["lpv", "lpv_long", "nl", "mpcc", "batch"])
def test_main_paths_pin_every_product(path):
    """Every dot_general in the step of each path chip_smoke.py drives is
    pinned to Precision.HIGHEST: none is left to the card's default,
    which runs float32 products in TF32 on the H100."""
    fn, arg = _main_path(path)
    precs = _dot_precisions(fn, arg)
    assert precs and all(_highest(p) for p in precs), precs
