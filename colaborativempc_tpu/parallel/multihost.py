"""Multi-host execution helpers.

The reference scales out by launching one ROS process per agent on one
machine (``launch/experiment.launch``); there is no multi-machine story.
Here scale-out is the standard JAX multi-controller model: every host runs
the same program, ``jax.distributed.initialize`` wires the hosts together,
and the global mesh spans all devices — collectives between the GPUs of
one host are NCCL over NVLink, those between hosts NCCL over the host
network. The fleet/OCD steps in parallel/ work
unchanged on a global mesh; only array placement differs (use
``jax.make_array_from_process_local_data`` for host-local inputs).

On a single host this module degrades to the local device mesh, which is
also how the test suite exercises the collective paths (8 virtual CPU
devices, conftest.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialise the multi-controller runtime (no-op on a single host).

    Pass all three arguments on a GPU cluster (``coordinator_address`` as
    ``host:port``); with none, JAX must find the cluster from its
    environment.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    else:
        try:
            jax.distributed.initialize()
        except Exception:  # single host / already initialised
            pass


def fleet_mesh(n_agents: int,
               devices=None,
               scen_axis: str = "scen",
               agent_axis: str = "agent") -> Tuple[Mesh, int]:
    """Build a (scenarios x agents) mesh over all (global) devices.

    The agent axis gets the largest divisor of the device count that is
    <= n_agents so a fleet is split across chips; the rest become the
    scenario (data-parallel) axis. Returns (mesh, n_scenario_shards).
    """
    devices = np.asarray(jax.devices() if devices is None else devices)
    n = devices.size
    agent_ax = 1
    for f in range(min(n_agents, n), 0, -1):
        if n % f == 0 and n_agents % f == 0:
            agent_ax = f
            break
    scen_ax = n // agent_ax
    mesh = Mesh(devices.reshape(scen_ax, agent_ax), (scen_axis, agent_axis))
    return mesh, scen_ax
