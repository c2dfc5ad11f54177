"""Test configuration: an 8-device virtual CPU mesh, no persistent cache.

The suite runs on the CPU. Multi-device collective code paths are
exercised on 8 virtual host devices (the "fake backend" testing mode; the
reference's analogue is running its ROS multi-process stack on one laptop
— SURVEY.md §4.4). Tests marked ``chip`` need a GPU: they check for one in
the ``gpu`` fixture and skip here; ``python chip_smoke.py`` runs the same
comparisons on the card.

The persistent compilation cache is switched off (through the environment,
so subprocesses inherit it): test runs leave no cache files in the
checkout.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")

assert jax.device_count() >= 8, (
    f"expected >=8 virtual CPU devices for sharding tests, got "
    f"{jax.device_count()}"
)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return devices[0]


def write_track_json(path, name="oval_mt", n=489):
    """A reference-format track JSON (MPCC ``Params/track.json`` layout:
    centerline X/Y, inner X_i/Y_i and outer X_o/Y_o boundaries) sampled
    from an in-repo track; returns ``path``."""
    import json

    import numpy as np
    import jax.numpy as jnp

    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.geometry.frenet import frenet_to_cartesian

    track = make_track(name, dtype=jnp.float32)
    L = float(track.track_length[0])
    hw = float(np.asarray(track.halfwidth[0]).min())
    s = jnp.linspace(0.0, L, n, endpoint=False)
    out = {}
    for key, ey in (("", 0.0), ("_i", hw), ("_o", -hw)):
        x, y, _ = frenet_to_cartesian(track, s, jnp.full_like(s, ey))
        out["X" + key] = np.asarray(x, np.float64).tolist()
        out["Y" + key] = np.asarray(y, np.float64).tolist()
    with open(path, "w") as f:
        json.dump(out, f)
    return str(path)


@pytest.fixture
def track_json(tmp_path):
    """Path of a reference-format track JSON built from ``oval_mt``."""
    return write_track_json(tmp_path / "track.json")


@pytest.fixture
def mpcc_params_dir(tmp_path):
    """A reference-layout MPCC ``Params`` directory: the master
    ``config.json`` with its model, bounds, normalization and track files
    (values of the reference's 1:43 car, ``MPCC-master/C++/Params``)."""
    import json

    files = {
        "config.json": {
            "n_sqp": 2, "n_reset": 5, "sqp_mixing": 0.8, "n_sim": 400,
            "Ts": 0.02, "v0": 0.5, "model_path": "model.json",
            "bounds_path": "bounds.json", "track_path": "track.json",
            "normalization_path": "normalization.json"},
        "model.json": {
            "m": 0.041, "Iz": 27.8e-6, "lf": 0.029, "lr": 0.033,
            "Bf": 2.579, "Cf": 1.2, "Df": 0.192, "Br": 3.3852,
            "Cr": 1.2691, "Dr": 0.1737, "Cm1": 0.287, "Cm2": 0.0545,
            "Cr0": 0.0518, "Cr2": 0.00035, "E_long": 0.9, "E_eps": 0.95,
            "maxAlpha": 0.6},
        "bounds.json": {"deltau": 0.35, "Dl": -0.1},
        "normalization.json": {
            "X": 3.0, "Y": 3.0, "phi": 3.14, "vx": 3.0, "vy": 3.0,
            "r": 8.0, "s": 20.0, "D": 1.0, "delta": 0.35, "dD": 15.0,
            "dDelta": 15.0},
    }
    for name, content in files.items():
        with open(tmp_path / name, "w") as f:
            json.dump(content, f)
    write_track_json(tmp_path / "track.json")
    return str(tmp_path)
