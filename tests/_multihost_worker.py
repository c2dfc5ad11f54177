"""Worker for the 2-process multi-controller test (run by test_sharding.py).

Each process owns 4 virtual CPU devices; ``jax.distributed.initialize``
wires the two controllers together (gloo cross-process collectives) and the
(2 scenarios x 4 agents) mesh spans all 8 global devices — the scenario
axis crosses the process (host-network-analogue) boundary, exactly the multi-host
layout of parallel/multihost.py. The worker runs one sharded LPV fleet step
over the global mesh and checks its addressable shards against the
single-device reference step computed locally.

Usage: python tests/_multihost_worker.py <pid> <nproc> <port>
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

try:
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
except Exception as e:  # pragma: no cover - environment-dependent
    print(f"DISTRIBUTED_INIT_FAILED: {e!r}")
    sys.exit(42)

import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from colaborativempc_tpu.config import (  # noqa: E402
    ExperimentConfig, lpv_gains, SolverConfig,
)
from colaborativempc_tpu.geometry import make_track  # noqa: E402
from colaborativempc_tpu.runtime import (  # noqa: E402
    init_lpv_fleet, make_lpv_fleet_step,
)
from colaborativempc_tpu.parallel import make_sharded_lpv_step  # noqa: E402

assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4
assert jax.process_count() == nproc

cfg = ExperimentConfig(
    n_agents=4, N=8, dt=0.025, max_it=10, map_type="oval",
    gains=lpv_gains(), solver=SolverConfig(admm_iters=400))
track = make_track(cfg.map_type)
state = init_lpv_fleet(track, cfg)

# deterministic on every controller: the single-device reference
ref_state, ref_metrics = make_lpv_fleet_step(track, cfg)(state)

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("scen", "agent"))

batched = jax.tree.map(
    lambda x: np.broadcast_to(np.asarray(x)[None], (2,) + x.shape).copy(),
    state)


def place(x):
    sh = NamedSharding(mesh, P("scen", "agent"))
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


gstate = jax.tree.map(place, batched)
step = make_sharded_lpv_step(track, cfg, mesh)
new_state, metrics = step(gstate)

# compare this process's addressable shards of x_pred with the reference
ref_xp = np.asarray(ref_state.x_pred)           # (n_ag, N+1, 9)
err = 0.0
for shard in new_state.x_pred.addressable_shards:
    sl = shard.index                            # (scen slice, agent slice, ...)
    want = np.broadcast_to(ref_xp[None], (2,) + ref_xp.shape)[sl]
    err = max(err, float(np.abs(np.asarray(shard.data) - want).max()))
assert err < 5e-4, err

# the sharded NL-OCD coordination step across the process boundary: the
# while_loop's agent-axis all_gathers ride intra-process devices, the
# per-scenario convergence pmin crosses the two controllers
import dataclasses
from colaborativempc_tpu.config import nl_gains, OCDConfig
from colaborativempc_tpu.runtime.ocd import init_nl_fleet, make_nl_ocd_step
from colaborativempc_tpu.parallel import make_sharded_nl_ocd_step

cfg_nl = dataclasses.replace(
    cfg, gains=nl_gains(), ocd=OCDConfig(max_it_ocd=8),
    solver=SolverConfig(admm_iters=100, sqp_iters=1))
nl_state = init_nl_fleet(track, cfg_nl)
nl_ref, nl_ref_m = make_nl_ocd_step(track, cfg_nl)(nl_state)

nl_batched = jax.tree.map(
    lambda x: np.broadcast_to(np.asarray(x)[None], (2,) + x.shape).copy(),
    nl_state)
def place_spec(x, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


specs = type(nl_state)(
    x0=P("scen", "agent"), x_pred=P("scen", "agent"),
    u_pred=P("scen", "agent"), u_old=P("scen", "agent"),
    lambdas=P("scen"),
    w=P("scen", "agent"), y=P("scen", "agent"),
    rho_scale=P("scen", "agent"),
    lane=P("scen", "agent"), hold_count=P("scen", "agent"),
    brake_count=P("scen", "agent"), jam_count=P("scen", "agent"))
nl_g = jax.tree.map(place_spec, nl_batched, specs)
nl_new, nl_m = make_sharded_nl_ocd_step(track, cfg_nl, mesh)(nl_g)
ref_nl_xp = np.asarray(nl_ref.x_pred)
err_nl = 0.0
for shard in nl_new.x_pred.addressable_shards:
    want = np.broadcast_to(ref_nl_xp[None], (2,) + ref_nl_xp.shape)[
        shard.index]
    err_nl = max(err_nl, float(np.abs(np.asarray(shard.data) - want).max()))
assert err_nl < 2e-3, err_nl

print(f"OK pid={pid} err={err:.2e} err_nl={err_nl:.2e}")
