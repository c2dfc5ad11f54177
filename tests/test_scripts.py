"""End-to-end CLI smoke tests: every user-facing script runs on tiny
workloads (the reference's validation style is runnable scripts,
SURVEY.md §4.1 — here they are also part of the formal suite, so a user
switching from the reference finds every entry point actually working)."""

import os
import sys

import numpy as np
import pytest


def _run(module_name, argv, monkeypatch):
    import importlib
    mod = importlib.import_module(f"colaborativempc_tpu.scripts.{module_name}")
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    mod.main()


def test_lpv_main_then_replay_and_model_eval(tmp_path, monkeypatch):
    out = str(tmp_path / "lpv")
    _run("lpv_main", ["--agents", "2", "--N", "8", "--steps", "4",
                      "--dt", "0.025", "--admm-iters", "300",
                      "--out", out, "--verb", "0"], monkeypatch)
    assert os.path.exists(os.path.join(out, "csv", "0", "states.dat"))
    assert os.path.exists(os.path.join(out, "track.png"))

    # replay the run (reference eval_exp) incl. the animation export
    _run("eval_exp", [out, "--gif", "--every", "2"], monkeypatch)
    assert os.path.exists(os.path.join(out, "replay.png"))
    assert os.path.exists(os.path.join(out, "run.gif"))

    # validate the LPV discretisation on the recorded inputs
    # (reference eval_LPV_model)
    _run("eval_lpv_model", [out, "--dt", "0.025", "--steps", "3"],
         monkeypatch)

    # paper-style trajectory overlay from the saved run
    _run("paper_figs", [out, "--out", str(tmp_path / "figs")], monkeypatch)


@pytest.mark.parametrize("script", ["lpv_main", "nl_main"])
def test_entry_points_run_without_matplotlib(script, tmp_path, monkeypatch,
                                             capsys):
    """Without matplotlib the runs and their records are unchanged; the
    figures are skipped with one line saying so."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "colaborativempc_tpu.runtime.plotting",
                        raising=False)
    out = str(tmp_path / script)
    _run(script, ["--agents", "2", "--N", "8", "--steps", "2",
                  "--out", out, "--verb", "0"], monkeypatch)
    assert os.path.exists(os.path.join(out, "csv", "0", "states.dat"))
    assert not os.path.exists(os.path.join(out, "track.png"))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("figures skipped")]
    assert len(lines) == 1 and "matplotlib" in lines[0]


def test_nl_main_gauss_seidel(tmp_path, monkeypatch):
    out = str(tmp_path / "nl")
    _run("nl_main", ["--agents", "2", "--N", "8", "--steps", "3",
                     "--sweep", "gauss_seidel", "--out", out,
                     "--verb", "0"], monkeypatch)
    assert os.path.exists(os.path.join(out, "csv", "0", "OCD_it.dat"))
    # fast path: derived per-iteration mean, never fabricated rows
    assert os.path.exists(os.path.join(out, "csv", "0",
                                       "time_OCD_mean.dat"))
    assert not os.path.exists(os.path.join(out, "csv", "0", "time_OCD.dat"))


def test_monte_carlo_both_pipelines(monkeypatch, capsys):
    _run("monte_carlo", ["--pipeline", "lpv", "--scenarios", "2",
                         "--agents", "2", "--N", "8", "--steps", "2"],
         monkeypatch)
    _run("monte_carlo", ["--pipeline", "nl", "--scenarios", "2",
                         "--agents", "2", "--N", "8", "--steps", "2"],
         monkeypatch)
    outp = capsys.readouterr().out
    assert "feasible scenarios: 2/2" in outp
    assert "OCD iterations/step" in outp


def test_battery_lpv(monkeypatch, capsys):
    _run("experiment_battery", ["--pipeline", "lpv", "--steps", "2",
                                "--agents", "2", "--N", "8"], monkeypatch)
    assert "progress=" in capsys.readouterr().out


def test_battery_mpcc(monkeypatch, capsys):
    _run("experiment_battery", ["--pipeline", "mpcc", "--steps", "3",
                                "--N", "8"], monkeypatch)
    outp = capsys.readouterr().out
    assert "racing" in outp and "qc=" in outp


def test_show_maps_and_planes(tmp_path, monkeypatch):
    _run("show_maps", ["oval", "--out", str(tmp_path)], monkeypatch)
    assert any(f.endswith(".png") for f in os.listdir(tmp_path))
    _run("test_planes", ["--out", str(tmp_path)], monkeypatch)


def test_mpcc_main(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "mpcc")
    _run("mpcc_main", ["--map", "oval_mt", "--N", "10", "--steps", "4",
                       "--out", out, "--save", "--verb", "0"], monkeypatch)
    assert "steps=4" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "csv", "0", "states.dat"))


def test_compare_reference_mock_golden(tmp_path, monkeypatch, capsys):
    """compare_reference is the parity-evidence generator (PARITY.md); smoke
    it against a mock golden run in the reference's on-disk schema."""
    golden = tmp_path / "mock_golden"
    # build the mock from an actual tiny run so trajectories are sane
    out = str(tmp_path / "gen")
    _run("lpv_main", ["--agents", "2", "--N", "8", "--steps", "6",
                      "--dt", "0.025", "--admm-iters", "200",
                      "--out", out, "--verb", "0"], monkeypatch)
    import shutil
    for a in range(2):
        d = golden / "csv" / str(a)
        d.mkdir(parents=True)
        shutil.copy(os.path.join(out, "csv", str(a), "states.dat"),
                    d / "states.dat")
    with open(golden / "settings.csv", "w") as f:
        f.write("n_agents,2\nN,8\ndt,0.025\nmap_type,Highway\n"
                "vx_ref,3.0\nmin_dist,0.25\n")
    _run("compare_reference", ["--ref", str(golden), "--steps", "5",
                               "--short", "3"], monkeypatch)
    outp = capsys.readouterr().out
    assert "behavioural deltas" in outp
    assert "short-horizon" in outp


def test_bench_suite_tiny(monkeypatch, capsys):
    _run("bench_suite", ["--tiny"], monkeypatch)
    outp = capsys.readouterr().out
    assert "solves_per_sec" in outp
    assert "fleet_steps_per_sec" in outp


def test_monte_carlo_mesh_sharded(monkeypatch, capsys):
    """--mesh runs the sweep as ONE scanned SPMD program over the virtual
    device mesh (parallel.make_sharded_*_rollout)."""
    _run("monte_carlo", ["--pipeline", "lpv", "--scenarios", "4",
                         "--agents", "2", "--N", "8", "--steps", "2",
                         "--mesh", "2x2"], monkeypatch)
    _run("monte_carlo", ["--pipeline", "nl", "--scenarios", "4",
                         "--agents", "2", "--N", "8", "--steps", "2",
                         "--mesh", "2x2"], monkeypatch)
    outp = capsys.readouterr().out
    assert outp.count("feasible scenarios: 4/4") == 2


def test_stress_study_cli(monkeypatch, capsys):
    """The robustness-study CLI (full-course / perturbed / latency) runs
    end to end on tiny workloads and reports the completion schema."""
    import json
    _run("stress_study", ["full-course", "--family", "lpv",
                          "--n", "8", "--steps", "3"], monkeypatch)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["study"].startswith("full-course/lpv")
    assert {"complete_all", "bad_steps", "held_steps",
            "p50_ms"} <= set(out)

    _run("stress_study", ["perturbed", "--family", "nl-eu", "--n", "8",
                          "--steps", "2", "--starts", "2"], monkeypatch)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["starts"] == 2 and "complete" in last

    _run("stress_study", ["latency", "--family", "lpv", "--n", "8",
                          "--steps", "3", "--variant", "seq"], monkeypatch)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["study"].startswith("latency/lpv")
