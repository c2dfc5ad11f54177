"""Collaborative multi-agent MPC on one GPU or a few.

A from-scratch JAX/XLA re-design of the capabilities of the reference
system ``MarcFacerias/ColaborativeMPC-`` (a Python/ROS1 distributed
multi-agent MPC trajectory planner for scaled autonomous cars):

- 9-state mixed Frenet/Cartesian bicycle model, LPV and fully nonlinear
  formulations (reference: planner/lib/plan_lib/distributedPlanner/LPV_Planner.py,
  nonLinDistribPlanner/base_nl.py)
- per-agent horizon MPC with tracking cost, road/actuator limits and slacks,
  solved on-device with a stage-structured Riccati+ADMM QP engine instead of
  OSQP/IPOPT (reference: LPV_Planner.py:192-249, NL_Planner_Eu.py:172-183)
- two collision-avoidance couplings: geometric separating hyperplanes and
  Euclidean distance (reference: planes/compute_plane.py, NL_Planner_Eu.py)
- OCD (Optimality Condition Decomposition) dual coordination across agents,
  run inside jit with collectives instead of ROS pub/sub
  (reference: planner/scripts/NL_EU_N_main.py:100-168, ROS/src/.../OCD_ROS_main.py)
- track database + Frenet-frame geometry (reference:
  mapManager/track_initialization.py)
- experiment harness, metrics writers and plotting with the reference's
  on-disk schema (reference: config/base_class.py, IOmodule/, plotter/)
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache: the nested coordination loops take tens
# of seconds to compile, so every later process should start warm. Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
# here; otherwise the cache lives at one fixed path inside the checkout
# (git-ignored), since the path is part of what makes a later run hit.
import os as _os
import jax as _jax
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from colaborativempc_tpu.geometry import Track, make_track, TRACK_NAMES
