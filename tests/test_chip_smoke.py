"""chip_smoke.py on the CPU: its phases at tiny sizes (the kernel in the
Pallas interpreter), each with its checks and reference comparisons, and
its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_lpv():
    return chip_smoke.phase_lpv(steps=3, N=12, n_agents=2)


def test_phase_lpv_tiny(tiny_lpv, capsys):
    assert tiny_lpv.steps == 3
    assert tiny_lpv.states.shape == (3, 2, 9)


def test_phase_nl_tiny(capsys):
    res = chip_smoke.phase_nl(steps=2, N=8, n_agents=2)
    assert res.steps == 2
    out = capsys.readouterr().out
    assert "[nl] ocd_iters_mean=" in out and "[nl] check=" in out


def test_phase_batch_tiny(capsys):
    chip_smoke.phase_batch(n_scen=2, horizon=8, steps=2, card="cpu")
    out = capsys.readouterr().out
    assert "[batch] solves_per_s=" in out and "[batch] check=" in out


def test_phase_mpcc_tiny(capsys):
    chip_smoke.phase_mpcc(steps=3, N=10)
    assert "[mpcc] check=finite states" in capsys.readouterr().out


def test_phase_reference_tiny(tiny_lpv, capsys):
    """Every reference comparison passes within the script's stated
    tolerances (the kernel in the interpreter here)."""
    chip_smoke.phase_reference(tiny_lpv, n_mat=2, per_mat=2, N=20,
                               kernel_B=3, kernel_N=6, loop_steps=3,
                               loop_N=12, n_agents=2, interpret=True)
    out = capsys.readouterr().out
    for what in ("riccati_vs_dense_kkt", "epoch_kernel_vs_xla",
                 "admm_solve_kernel_vs_xla", "lpv_steps_f32_vs_f64_cpu",
                 "closed_loop_f32_vs_f64_cpu"):
        assert what in out
    # the replayed float32 steps are the lpv phase's own first steps
    assert "replay_vs_lpv_phase=0.0" in out


def test_floor_check_rejects_a_breach():
    from colaborativempc_tpu.config import ExperimentConfig
    cfg = ExperimentConfig()
    x0 = np.zeros((2, 9))
    x0[1, 8] = 0.3                      # 0.3 m apart at the start
    floor = cfg.exec_sep_frac * cfg.limits.min_dist
    assert chip_smoke.floor_ok(cfg, x0, np.array([0.3, floor]))
    assert not chip_smoke.floor_ok(cfg, x0, np.array([0.3, floor - 1e-3]))


def test_check_raises():
    with pytest.raises(AssertionError, match="broken"):
        chip_smoke.check(False, "broken")


def _run(cmd, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_main_exits_nonzero_without_gpu():
    p = _run([sys.executable, "chip_smoke.py"], REPO,
             {"PYTHONPATH": REPO})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_main_exits_nonzero_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    fails before printing a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=dict(env, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_phase_four_on_virtual_devices(capsys):
    """The four-card phase on four virtual CPU devices: sharded rollouts
    and the hp_opt step agree with the one-device runs, and the state's
    shards lie on four devices."""
    import jax
    chip_smoke.phase_four(jax.devices()[:4], n_scen=4, N=8, steps=2)
    out = capsys.readouterr().out
    assert out.count("devices=4") == 3


def test_lpv_steps_vs_f64_tiny():
    """One float32 step at a time against float64 from the same state:
    per-step errors at the solver's tolerance, and the float32 states of
    the replayed loop."""
    r = chip_smoke.lpv_steps_vs_f64(steps=3, N=12, n_agents=2)
    assert r["states"].shape == (3, 2, 9)
    assert r["state"] < chip_smoke.STEP_TOL, r
    assert r["input"] < chip_smoke.STEP_TOL, r


def test_lockstep_catches_a_wrong_shard():
    """The four-card comparison passes twin programs and fails one whose
    plans are off by twice the tolerance."""
    from collections import namedtuple

    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:4]), ("scen",))
    State = namedtuple("State", "x0 x_pred")
    put = lambda a: jax.device_put(  # noqa: E731
        np.asarray(a, np.float32), NamedSharding(mesh, P("scen")))
    st = State(put(np.ones((4, 3, 9))), put(np.ones((4, 3, 5, 9))))
    step = jax.jit(lambda s: (State(s.x0 * 1.01, s.x_pred + 0.1), None))

    def twin(off):
        return lambda s: (State(np.asarray(s.x0) * np.float32(1.01),
                                np.asarray(s.x_pred) + np.float32(0.1 + off)),
                          None)

    chip_smoke.lockstep("twin", 4, 2, step, st, twin(0.0))
    with pytest.raises(AssertionError, match="wrong"):
        chip_smoke.lockstep("wrong", 4, 2, step, st,
                            twin(2 * chip_smoke.SHARD_TOL))
