"""The port's command-line app (`python -m povar_tpu_torch.cli`) against
the JAX package's (`python -m povar_tpu.cli`), in process through their
`main([...])`, on the committed BAL fixture tests/data/mini-bal-12-48-pre
.txt (12 cameras, 48 landmarks, 192 observations).

Both apps first randomize the cameras (`--create-dataset`, which writes
data_custom/ and exits 0), then solve the written file with
SolverOptions() defaults, step 2 cut to its first STEP2_ITERS
iterations: the port with `--device cpu` (every kernel call runs its
plain PyTorch version), the JAX package with the Pallas kernels in
interpret mode and the host LM loop (`--solver-pallas-kernels on
--solver-device-lm-loop off`). Checked: the two data_custom/ files are
byte-identical; both ba_log.json files have the same keys at every
level; accept/reject decisions and the power-term counts of both steps
are the same; the costs agree within the tolerances of
test_cli_solve_matches_jax; `--dump-config` round-trips;
povar_tpu_torch.tools (its log loader and the report generator) read the
port's log, as povar_tpu.tools does. And without a card the app refuses to solve unless given
`--device cpu`; `--mesh-devices` above the card count exits 1; with
`--device cpu`, `--mesh-devices 2` solves as two gloo ranks.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from povar_tpu import cli as jax_cli
from povar_tpu_torch import cli

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "mini-bal-12-48-pre.txt")
NAME = os.path.basename(FIXTURE)
DATA = os.path.join("data_custom", NAME)
# Step 2 on this file is chaotic past its first iterations: from the
# step-1 results of the JAX package's own Pallas and XLA paths (1e-3
# apart) its decisions part at iteration 8 (measured; the port's at the
# same place), so both apps stop step 2 after 7 iterations, as the
# card's step-2 witness does (povar_tpu_torch/tools/step2_spread.py).
STEP2_ITERS = 7


def _create(workdir, main):
    """--create-dataset in `workdir`; returns the written file's bytes."""
    shutil.copy(FIXTURE, workdir / NAME)
    with pytest.raises(SystemExit) as e:
        main(["--input", NAME, "--create-dataset"])
    assert e.value.code in (0, None)
    return (workdir / DATA).read_bytes()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax" | "torch": (data_custom bytes, ba_log dict, log path)} of
    both apps' create + solve, each in a directory of its own."""
    out = {}
    cwd = os.getcwd()
    try:
        for label, main, flags in (
            ("jax", jax_cli.main, ["--solver-pallas-kernels", "on",
                                   "--solver-device-lm-loop", "off"]),
            ("torch", cli.main, ["--device", "cpu"]),
        ):
            work = tmp_path_factory.mktemp(label) / "mini-bal-12-48"
            work.mkdir()
            os.chdir(work)
            data = _create(work, main)
            assert main(["--input", DATA, *flags,
                         "--solver-max-num-iterations-step-2",
                         str(STEP2_ITERS)]) == 0
            path = work / "ba_log.json"
            out[label] = (data, json.loads(path.read_text()), path)
    finally:
        os.chdir(cwd)
    return out


def _keys(d, prefix=""):
    """Every key path of a JSON object (lists of objects by their first
    element)."""
    keys = set()
    for k, v in d.items():
        keys.add(prefix + k)
        if isinstance(v, dict):
            keys |= _keys(v, prefix + k + ".")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            keys |= _keys(v[0], prefix + k + "[].")
    return keys


def test_create_dataset_is_byte_identical(runs):
    assert runs["torch"][0] == runs["jax"][0]
    assert len(runs["torch"][0]) > 0


def test_log_has_the_jax_schema(runs):
    jlog, tlog = runs["jax"][1], runs["torch"][1]
    assert _keys(tlog) == _keys(jlog)
    assert tlog["_type"] == jlog["_type"] == "rootba_povar"
    for key in ("solver1", "solver"):
        assert tlog[key]["solver_type"] == jlog[key]["solver_type"]


def test_cli_solve_matches_jax(runs):
    """SolverOptions() defaults (POWER_VARPROJ and RIPOBA with the fused
    power term): the same decisions and power-term counts in both steps
    (24 step-1 iterations to convergence, 7 of step 2). Step 1's final
    cost within 1e-3 (measured 1.1e-4; the JAX package's own XLA path
    ends 2.1e-3 from its Pallas path on this file). Step 2 starts from
    the homogenized step-1 result, which amplifies step 1's rounding:
    its final cost within 0.25 (measured 3.7% apart at the start and 16%
    after 7 iterations; over the same iterations the JAX package's own
    XLA path is up to 22% from its Pallas path)."""
    jlog, tlog = runs["jax"][1], runs["torch"][1]
    for key, tol in (("iterations1", 1e-3), ("iterations", 0.25)):
        ti, ji = tlog[key], jlog[key]
        assert [it["step_is_successful"] for it in ti] == [
            it["step_is_successful"] for it in ji
        ], key
        assert [it["linear_solver_iterations"] for it in ti] == [
            it["linear_solver_iterations"] for it in ji
        ], key
        np.testing.assert_allclose(ti[-1]["cost"], ji[-1]["cost"],
                                   rtol=tol)
        accepted = [it["cost"] for it in ti if it["step_is_successful"]]
        assert all(b < a for a, b in zip(accepted, accepted[1:])), key


def test_tools_read_the_port_log(runs, tmp_path):
    """The port's report tools (povar_tpu_torch.tools, copies of
    povar_tpu.tools) load the port's log, and their report generator
    renders a cost table over both apps' runs; povar_tpu.tools, read as
    a cross-check, loads the same numbers and renders the same table."""
    from povar_tpu.tools import report as jax_report
    from povar_tpu.tools.log import Log as JaxLog
    from povar_tpu_torch.tools import report
    from povar_tpu_torch.tools.log import Log

    log = Log.load(str(runs["torch"][2]))
    assert log.final_cost() > 0 and log.final_cost("iterations1") > 0
    assert log.problem_info.num_cameras == 12
    jlog = JaxLog.load(str(runs["torch"][2]))
    assert jlog.final_cost() == log.final_cost()
    assert jlog.final_cost("iterations1") == log.final_cost("iterations1")
    for label in ("jax", "torch"):
        run = tmp_path / label / "mini-bal-12-48"
        run.mkdir(parents=True)
        shutil.copy(runs[label][2], run / "ba_log.json")
    cfg = tmp_path / "exp.toml"
    cfg.write_text(
        '[[experiments]]\nname = "jax"\npattern = "jax/*"\n\n'
        '[[experiments]]\nname = "torch"\npattern = "torch/*"\n\n'
        '[[results]]\nclass = "results_table"\nname = "costs"\n'
        'metrics = ["cost"]\n'
    )
    tables = []
    for main, out in ((report.main, tmp_path / "results"),
                      (jax_report.main, tmp_path / "results_jax")):
        assert main([str(cfg), "-o", str(out)]) == 0
        tables.append((out / "costs.txt").read_text())
    assert "mini-bal-12-48" in tables[0]
    assert tables[0] == tables[1]


def test_dump_config_round_trips(tmp_path, capsys, monkeypatch):
    """--dump-config prints the effective options as TOML; reloading
    that file with --config prints the same text, and an override on
    top of it shows up."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--dump-config",
                     "--solver-solver-type-step-1", "PCG"]) == 0
    first = capsys.readouterr().out
    assert 'solver_type_step_1 = "PCG"' in first
    (tmp_path / "c.toml").write_text(first)
    assert cli.main(["--config", "c.toml", "--dump-config"]) == 0
    assert capsys.readouterr().out == first
    assert cli.main(["--config", "c.toml", "--dump-config",
                     "--solver-max-num-iterations-step-2", "7"]) == 0
    assert "max_num_iterations_step_2 = 7" in capsys.readouterr().out


def test_without_a_card_the_cli_refuses_to_solve(tmp_path, capsys,
                                                 monkeypatch):
    """The default --device cuda exits 1 without a CUDA device, before
    any solve, and names --device cpu, with or without --mesh-devices."""
    monkeypatch.chdir(tmp_path)
    _create(tmp_path, cli.main)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mesh in ([], ["--mesh-devices", "1"], ["--mesh-devices", "2"]):
        assert cli.main(["--input", DATA, *mesh]) == 1
        assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "ba_log.json").exists()


def test_mesh_devices_above_the_card_count_exit_1(tmp_path, capsys,
                                                  monkeypatch):
    """--mesh-devices above the card count exits 1 before any solve, as
    the JAX app does for too few devices (here with one card
    pretended)."""
    monkeypatch.chdir(tmp_path)
    _create(tmp_path, cli.main)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["--input", DATA, "--mesh-devices", "2"]) == 1
    assert "only 1 devices available" in capsys.readouterr().err
    assert not (tmp_path / "ba_log.json").exists()


def test_mesh_devices_on_the_cpu(tmp_path, monkeypatch):
    """--device cpu --mesh-devices 2 solves as two gloo ranks (the SPMD
    window layout): one ba_log.json, written by rank 0, with both steps'
    records and strictly falling accepted costs; --mesh-devices 1 solves
    in process to the same decisions."""
    monkeypatch.chdir(tmp_path)
    _create(tmp_path, cli.main)
    logs = []
    for n in ("2", "1"):
        log = tmp_path / f"ba_log_{n}.json"
        assert cli.main(["--input", DATA, "--device", "cpu",
                         "--mesh-devices", n, "--log-file", str(log),
                         "--solver-max-num-iterations-step-1", "6",
                         "--solver-max-num-iterations-step-2", "4"]) == 0
        logs.append(json.loads(log.read_text()))
    assert sorted(p.name for p in tmp_path.glob("*.json")) == [
        "ba_log_1.json", "ba_log_2.json"]
    for log in logs:
        assert len(log["iterations1"]) == 7 and len(log["iterations"]) == 5
        for key in ("iterations1", "iterations"):
            acc = [it["cost"] for it in log[key] if it["step_is_successful"]]
            assert all(b < a for a, b in zip(acc, acc[1:])), acc
    assert ([it["step_is_successful"] for it in logs[0]["iterations1"]]
            == [it["step_is_successful"] for it in logs[1]["iterations1"]])


def test_profile_dir_and_ubjson_log(tmp_path, monkeypatch):
    """--profile-dir writes a torch.profiler Chrome trace of the solve
    and --log-ubjson a UBJSON copy of the log that decodes to the JSON
    log (the port's copy of the JAX package's encoder)."""
    from povar_tpu_torch.utils import ubjson

    monkeypatch.chdir(tmp_path)
    _create(tmp_path, cli.main)
    assert cli.main(["--input", DATA, "--device", "cpu", "--profile-dir",
                     "prof", "--log-ubjson",
                     "--solver-max-num-iterations-step-1", "2",
                     "--solver-max-num-iterations-step-2", "2"]) == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    log = json.loads((tmp_path / "ba_log.json").read_text())
    assert ubjson.loads((tmp_path / "ba_log.ubjson").read_bytes()) == log
    assert len(log["iterations1"]) == len(log["iterations"]) == 3
