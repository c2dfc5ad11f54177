"""Shared script plumbing: backend selection and optional figures.

Utility scripts do eager geometry; ``--cpu`` forces the host backend (must
run before heavy jax use). Figures need matplotlib, which the runs and
their on-disk records do not: where it is missing, the scripts say so on
one line and skip the figures.
"""

import importlib
import os
import sys


def setup_backend(argv=None):
    """Consume a --cpu flag (if present) and force the CPU platform."""
    argv = sys.argv if argv is None else argv
    if "--cpu" in argv:
        argv.remove("--cpu")
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")


def plotting():
    """``runtime.plotting``, or None (after one line saying so) where
    matplotlib is not installed."""
    try:
        mod = importlib.import_module("colaborativempc_tpu.runtime.plotting")
    except ImportError as e:
        print(f"figures skipped: {e}")
        return None
    return mod


def save_figures(map_type: str, states, dt: float, path: str) -> None:
    """Track overlay and performance plots of a run, when matplotlib is
    installed."""
    mod = plotting()
    if mod is None:
        return
    from colaborativempc_tpu.geometry import make_track
    mod.plot_experiment(make_track(map_type), states, path=path)
    mod.plot_performance(states, dt, path=path)
