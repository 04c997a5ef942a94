"""The port's report tools (povar_tpu_torch/tools/: log model, runs,
tables, profiles, plots, the report generator, FLOP models; copies of
povar_tpu/tools/) and its native BAL tokenizer (csrc/bal_io.cpp through
utils/native.py), on the CPU, without jax.

The tools' cases are those of tests/test_tools.py, run against the
port's copies. The tokenizer: the native tokens equal the numpy
tokenizer's (problem/bal_io.numpy_tokens, its plain version) bit for bit
on the committed BAL fixture and on a written 89-camera BAL text; a
missing file raises the JAX package's FileNotFoundError; a source that
does not compile raises with the compiler's output.
"""

import json
import os

import numpy as np
import pytest
import torch

from povar_tpu_torch.tools.log import Log, _convert
from povar_tpu_torch.tools.run import Experiment, Run
from povar_tpu_torch.tools.tables import (
    performance_profile,
    results_table,
    time_to_cost_tolerance,
)
from povar_tpu_torch.tools.num_ops import ProblemDims, solve_flops

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "mini-bal-12-48-pre.txt")


def _fake_log(costs, dt=1.0):
    its = []
    for i, c in enumerate(costs):
        its.append(
            {
                "iteration": i,
                "step_is_successful": True,
                "cost": c,
                "cumulative_time": (i + 1) * dt,
            }
        )
    return Log({"iterations": its, "solver": {"total_time_in_seconds": 9.0}})


def test_log_cost_curve_and_final():
    log = _fake_log([10.0, 5.0, 2.0, 1.0])
    t, c = log.cost_curve()
    np.testing.assert_allclose(c, [10, 5, 2, 1])
    assert log.final_cost() == 1.0
    assert log.total_time() == 9.0


def test_reference_index_values_decode(tmp_path):
    """Reference-format `<name>__index/<name>__values` fields must decode
    with the SPLIT-at-start-indices semantics of python/rootba/log.py:56-63
    (values concatenated, __index = start offset of each row)."""
    raw = {
        "solver": {
            "cg_iter__index": [0, 3, 5],
            "cg_iter__values": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0],
            "even__index": [0, 2],
            "even__values": [10.0, 11.0, 20.0, 21.0],
            "plain": 5,
        }
    }
    out = _convert(raw)
    rows = out["solver"]["cg_iter"]
    assert len(rows) == 3
    np.testing.assert_allclose(rows[0], [1.0, 2.0, 3.0])
    np.testing.assert_allclose(rows[1], [4.0, 5.0])
    np.testing.assert_allclose(rows[2], [6.0, 7.0])
    # equal-length rows stack into a 2-D array like the reference
    np.testing.assert_allclose(
        out["solver"]["even"], [[10.0, 11.0], [20.0, 21.0]]
    )
    assert out["solver"]["plain"] == 5

    # end-to-end through Log.load
    p = tmp_path / "ba_log.json"
    p.write_text(json.dumps(raw))
    log = Log.load(str(p))
    assert len(log.data["solver"]["cg_iter"]) == 3


def test_time_to_cost_tolerance():
    log = _fake_log([10.0, 5.0, 2.0, 1.0])
    # threshold 1.0 * 1.5 = 1.5 -> first reached at iteration 3 (t=4)
    assert time_to_cost_tolerance(log, 0.5) == 4.0
    # tolerance 9 -> threshold 10 -> reached at t=1
    assert time_to_cost_tolerance(log, 9.0) == 1.0


def test_results_table_renders():
    runs = {
        "ladybug-49": {"power": _fake_log([5.0, 1.0])},
        "venice-89": {"power": _fake_log([8.0, 2.0]), "pcg": None},
    }
    runs["venice-89"].pop("pcg")
    txt = results_table(runs)
    assert "ladybug-49" in txt and "power" in txt


def test_performance_profile():
    times = {"a": [1.0, 2.0, None], "b": [2.0, 2.0, 5.0]}
    taus, prof = performance_profile(times, taus=[1.0, 2.0, 10.0])
    # a is best on problem 0, tied on 1, fails 2
    np.testing.assert_allclose(prof["a"], [2 / 3, 2 / 3, 2 / 3])
    np.testing.assert_allclose(prof["b"], [2 / 3, 1.0, 1.0])


def test_run_failure_detection(tmp_path):
    d1 = tmp_path / "run1"
    d1.mkdir()
    (d1 / "status.log").write_text("Created\nCompleted\n")
    d2 = tmp_path / "run2"
    d2.mkdir()
    (d2 / "status.log").write_text("Created\n")
    exp = Experiment.load("test", str(tmp_path / "run*"))
    assert not exp.runs["run1"].is_failed
    assert exp.runs["run2"].is_failed
    assert exp.failed_runs == ["run2"]


def test_experiment_cache(tmp_path):
    d1 = tmp_path / "runA"
    d1.mkdir()
    (d1 / "status.log").write_text("Completed")
    cache = str(tmp_path / "cache")
    e1 = Experiment.load("x", str(tmp_path / "run*"), cache_dir=cache)
    assert len(os.listdir(cache)) == 1
    e2 = Experiment.load("x", str(tmp_path / "run*"), cache_dir=cache)
    assert list(e2.runs) == list(e1.runs)


def test_flop_models_ordering():
    d = ProblemDims(n_poses=1778, n_landmarks=993923, n_obs=5001946)
    p = solve_flops(d, "power_varproj", power_terms=10)
    c = solve_flops(d, "cholesky")
    assert p > 0
    # direct Cholesky of a 21336^2 system dwarfs 10 power terms
    assert c > p


def test_ubjson_roundtrip():
    from povar_tpu_torch.utils import ubjson

    doc = {
        "a": 1,
        "b": -3.5,
        "c": "hello",
        "d": [1, 2.0, "x", None, True, False],
        "nested": {"k": [255, 70000, 2**40]},
    }
    assert ubjson.loads(ubjson.dumps(doc)) == doc


def test_ubjson_log_load(tmp_path):
    from povar_tpu_torch.utils import ubjson

    data = {
        "iterations": [
            {"iteration": 0, "step_is_successful": True, "cost": 5.0,
             "cumulative_time": 1.0},
            {"iteration": 1, "step_is_successful": True, "cost": 2.0,
             "cumulative_time": 2.0},
        ]
    }
    p = tmp_path / "ba_log.ubjson"
    p.write_bytes(ubjson.dumps(data))
    log = Log.load(str(p))
    assert log.final_cost() == 2.0


def _write_run_dir(root, exp, prob, costs, total_time, n_cams=10):
    """A minimal run directory a batch run would produce."""
    d = os.path.join(root, exp, prob)
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, "status.log"), "w").write("Created\nCompleted\n")
    its = [
        {
            "iteration": i,
            "step_is_valid": True,
            "step_is_successful": True,
            "cost": c,
            "cumulative_time": (i + 1) * total_time / len(costs),
            "linear_solver_iterations": 3,
            "stage1_time": 0.1,
            "stage2_time": 0.05,
            "solve_reduced_system_time": 0.2,
            "prepare_time": 0.02,
            "back_substitution_time": 0.03,
        }
        for i, c in enumerate(costs)
    ]
    log = {
        "problem_info": {
            "num_cameras": n_cams,
            "num_landmarks": 100,
            "num_observations": 500,
            "rcs_sparsity": 0.25,
            "per_lm_obs": {"mean": 5.0, "min": 2, "max": 9,
                           "stddev": 1.0},
        },
        "solver": {
            "total_time_in_seconds": total_time,
            "minimizer_time_in_seconds": total_time * 0.9,
            "num_linear_solves": len(costs),
            "num_residual_evaluations": len(costs),
            "num_jacobian_evaluations": len(costs),
            "resident_memory_peak": 2 << 30,
        },
        "solver1": {"minimizer_time_in_seconds": total_time * 0.4},
        "iterations": its,
        "iterations1": its[:2],
    }
    json.dump(log, open(os.path.join(d, "ba_log.json"), "w"))


def _two_experiment_tree(root):
    for prob, (t_a, t_b) in {
        "ladybug-49": (4.0, 6.0),
        "venice-89": (10.0, 9.0),
    }.items():
        _write_run_dir(root, "power", prob, [100.0, 10.0, 2.0, 1.0], t_a)
        _write_run_dir(root, "pcg", prob, [100.0, 20.0, 3.0, 1.05], t_b)


def test_metric_registry_and_relative(tmp_path):
    """Metric accessors + relative-to-experiment baselines
    (python/rootba/metric.py:31-190 semantics)."""
    from povar_tpu_torch.tools.experiments import (
        load_experiments_config,
        load_experiments,
    )
    from povar_tpu_torch.tools.metrics import get_metric

    _two_experiment_tree(tmp_path)
    cfg_path = os.path.join(tmp_path, "exp.toml")
    open(cfg_path, "w").write(
        """
[substitutions]
base = "."

[[experiments]]
name = "power"
pattern = "${base}/power/*"

[[experiments]]
name = "pcg"
pattern = "${base}/pcg/*"
"""
    )
    config = load_experiments_config(cfg_path)
    exps = load_experiments(config)
    assert set(exps) == {"power", "pcg"}
    assert exps["power"].sequences() == ["ladybug-49", "venice-89"]

    m = get_metric("cost")
    assert m.value(exps, exps["power"], "ladybug-49") == 1.0
    m = get_metric("solver_total_time")
    assert m.value(exps, exps["pcg"], "venice-89") == 9.0
    # relative-to-experiment ratio (geometric-mean display defaults)
    m = get_metric(
        {"name": "solver_total_time", "relative_to_experiment": "power"}
    )
    assert m.geometric_mean
    np.testing.assert_allclose(
        m.value(exps, exps["pcg"], "ladybug-49"), 6.0 / 4.0
    )
    # name@itN pinning
    m = get_metric(
        {"name": "cost", "relative_to_experiment": "power@it0"}
    )
    np.testing.assert_allclose(
        m.value(exps, exps["pcg"], "venice-89"), 1.05 / 100.0
    )


def test_experiments_template_expansion(tmp_path):
    """Template + substitution expansion (experiments.py:292-623
    capability: cartesian expansion over list-valued args, ${var} and
    <var> substitution)."""
    from povar_tpu_torch.tools.experiments import load_experiments_config

    cfg = os.path.join(tmp_path, "exp.toml")
    open(cfg, "w").write(
        """
[substitutions]
solvers = ["power", "pcg"]
tol = 0.01

[[templates]]
name = "per-solver-plot"
args = ["solver"]
class = "plot"
x = "time"

[[experiments]]
name = "power"
pattern = "runs/power/*"

[[results]]
template = "per-solver-plot"
solver = "<solvers>"
name = "conv-${solver}"
experiments = ["${solver}"]

[[results]]
class = "performance_profile"
name = "profile"
tolerance = "<tol>"
"""
    )
    config = load_experiments_config(cfg)
    results = config["results"]
    # the templated entry expands to one plot per solver, spliced
    assert [r.get("name") for r in results] == [
        "conv-power", "conv-pcg", "profile"
    ]
    assert results[0]["class"] == "plot"
    assert results[0]["experiments"] == ["power"]
    assert results[1]["experiments"] == ["pcg"]
    assert results[2]["tolerance"] == 0.01


def test_report_end_to_end(tmp_path):
    """generate_tables.py-equivalent: config -> tables + profile +
    plots + report.md in one command."""
    from povar_tpu_torch.tools import report as report_mod

    _two_experiment_tree(tmp_path)
    cfg = os.path.join(tmp_path, "exp.toml")
    open(cfg, "w").write(
        """
[[experiments]]
name = "power"
pattern = "power/*"

[[experiments]]
name = "pcg"
pattern = "pcg/*"

[[results]]
class = "overview_table"
name = "overview"

[[results]]
class = "results_table"
name = "costs"
metrics = ["cost", "num_it_total", "solver_total_time"]

[[results]]
class = "performance_profile"
name = "profile"
tolerance = 0.1

[[results]]
class = "plot"
name = "convergence"

[[results]]
class = "timing_breakdown"
name = "timing"
"""
    )
    out = os.path.join(tmp_path, "results")
    rc = report_mod.main([cfg, "-o", out])
    assert rc == 0
    txt = open(os.path.join(out, "costs.txt")).read()
    assert "ladybug-49" in txt and "venice-89" in txt
    assert "1.000e+00" in txt  # power final cost
    assert os.path.exists(os.path.join(out, "costs.tex"))
    assert os.path.exists(os.path.join(out, "profile.png"))
    assert os.path.exists(os.path.join(out, "convergence.png"))
    assert os.path.exists(os.path.join(out, "overview.txt"))
    assert os.path.exists(
        os.path.join(out, "timing-ladybug-49.png")
    )
    md = open(os.path.join(out, "report.md")).read()
    assert "## costs" in md and "profile.png" in md
    ov = open(os.path.join(out, "overview.txt")).read()
    assert "10" in ov and "25%" in ov


def test_summarize_table(tmp_path):
    """Sequence-aggregated metric comparison with best/second marks
    (latex/summarize_sequences_table.py equivalent)."""
    from povar_tpu_torch.tools.experiments import (
        load_experiments_config,
        load_experiments,
    )
    from povar_tpu_torch.tools.tables import summarize_table

    _two_experiment_tree(tmp_path)
    cfg = os.path.join(tmp_path, "exp.toml")
    open(cfg, "w").write(
        """
[[experiments]]
name = "power"
pattern = "power/*"

[[experiments]]
name = "pcg"
pattern = "pcg/*"
"""
    )
    exps = load_experiments(load_experiments_config(cfg))
    txt = summarize_table(
        exps, ["power", "pcg"], ["cost", "solver_total_time"]
    )
    # power has lower final cost on both problems -> best mark
    line = [l for l in txt.splitlines() if l.startswith("cost")][0]
    assert "*" in line.split()[1] + line.split()[2]
    tex = summarize_table(
        exps, ["power", "pcg"], ["cost"], latex=True
    )
    assert "\\textbf" in tex


# ------------------------------------------------------------ tokenizer


def _same_bits(a, b):
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    assert np.array_equal(a.view(np.int64), b.view(np.int64))


def test_native_tokens_equal_numpy_on_the_fixture():
    from povar_tpu_torch.problem import bal_io
    from povar_tpu_torch.utils import native

    got = native.parse_tokens(FIXTURE)
    _same_bits(got, bal_io.numpy_tokens(FIXTURE))
    # 12 cameras, 48 landmarks, 192 observations, read by the loader
    assert got[:3].tolist() == [12, 48, 192]
    assert bal_io.load_bal_text(FIXTURE)[:3] == (12, 48, 192)


def test_native_tokens_equal_numpy_on_a_written_89_camera_file(tmp_path):
    """A BAL text of 89 cameras (write_bal_text, 17 significant digits,
    negative values and exponents among them) parses to the same f64
    bits natively and with numpy."""
    from povar_tpu_torch.problem import bal_io
    from povar_tpu_torch.problem.synthetic import (
        synthetic_bal_problem_fast, write_bal_text)
    from povar_tpu_torch.utils import native

    p = synthetic_bal_problem_fast(89, 2000, 5, seed=0)
    path = str(tmp_path / "problem-89-2000-pre.txt")
    write_bal_text(path, p.num_cameras, p.num_landmarks, p.obs_cam,
                   p.obs_lm, p.obs_uv, lm_p=p.lm_p)
    got = native.parse_tokens(path)
    _same_bits(got, bal_io.numpy_tokens(path))
    assert got[:3].tolist() == [89, 2000, p.num_observations]


def test_missing_file_raises_file_not_found(tmp_path):
    from povar_tpu_torch.problem import bal_io

    missing = str(tmp_path / "nope.txt")
    with pytest.raises(FileNotFoundError, match="Could not open"):
        bal_io._read_tokens(missing)


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError carrying the
    compiler's message, and nothing is loaded in its place."""
    from povar_tpu_torch.utils import native

    bad = tmp_path / "bal_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()
    assert not list((tmp_path / "build").rglob("*.so"))
