"""Scoped float64 islands.

The reference's solvers run full float64 (OSQP/IPOPT, ``LPV_Planner.py:
222-239``); this framework is float32-first (full float32, never TF32), with
float64 available as an *island*: code that requests ``dtype="float64"``
(ExperimentConfig.dtype, ``fit_centerline(..., dtype=jnp.float64)``) runs
under a scoped ``jax_enable_x64`` toggle so its arrays and traces really are
double precision — JAX otherwise silently truncates explicit f64 requests
to f32 (the "dead knob" failure mode).

Enabling x64 globally does NOT disturb float32 paths: this codebase creates
every traced array with an explicit dtype, and JAX keeps explicit f32
arrays f32 under ``jax_enable_x64=True`` (weak Python literals do not
promote them). The island only changes what *requested* f64 means. jit
caches key on the flag, so toggling re-traces rather than mixing.

Note: the H100 runs float64 natively, at a fraction of its float32 rate,
so the island works on the GPU as well as on the CPU (tests, host-side
geometry tables, high-precision validation runs). ``run_*_experiment``
enter the island automatically when ``cfg.dtype == "float64"``.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np


@contextlib.contextmanager
def x64_island(enable: bool = True):
    """Scoped ``jax_enable_x64``: enables x64 inside the block (never
    *disables* an already-enabled flag), restoring the previous value on
    exit."""
    prev = bool(jax.config.jax_enable_x64)
    if enable and not prev:
        jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        if enable and not prev:
            jax.config.update("jax_enable_x64", False)


def dtype_island(dtype):
    """``x64_island`` gated on the requested dtype (string or jnp dtype)."""
    if isinstance(dtype, str):
        want64 = dtype in ("float64", "f64")
    else:
        want64 = np.dtype(dtype) == np.dtype("float64")
    return x64_island(want64)
