"""Whole runs of the cells at a tiny size on the CPU: the program's runs come
out correct, the control's and every planted fault's come out not correct; a
cell added as files runs with no code edited; the command refuses to run
without a CUDA device.  The card test at the end runs each cell for real."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import faults, harness

from .conftest import REPO, STREAMED

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY_CELLS = CELLS + [STREAMED]
SEED = 2**31 + 11


def _run(root, cell, trace=False, wrap=None, seconds=1.5):
    return harness.run_cell(root, cell, SEED, seconds, trace, time.perf_counter(),
                            device="cpu", wrap=wrap)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_the_program_runs_correct(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == names
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("stand_in", sorted(faults.WRAPS))
def test_the_control_and_every_fault_come_out_not_correct(tiny_root, cell, stand_in):
    r = _run(tiny_root, cell, wrap=faults.WRAPS[stand_in])
    assert not r["correct"], (stand_in, r["checks"])
    assert r["failed"] > 0


def test_a_traced_run_reports_per_layer_metrics_only(tiny_root):
    r = _run(tiny_root, STREAMED, trace=True)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    per_layer = {m["name"] for m in bench["per_layer"]}
    assert set(r["metrics"]) <= per_layer
    assert "busy_s" in r["device"] and "window_s" in r["device"]


def test_a_cell_added_as_files_runs_without_any_code_edit(tiny_root):
    """A new configuration, traffic mix, reference and metric, each a new
    file, plus entries in BENCHMARK.json."""
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "boxblur_r13_yuv420p16_1080p.json").read_text())
    cfg.update(name="boxblur_r5_new", args={"hradius": 5, "vradius": 5}, reference="boxblur_new")
    (pb / "configs" / "boxblur_r5_new.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "reference" / "boxblur.py", pb / "reference" / "boxblur_new.py")
    mix = json.loads((pb / "mixes" / "resident_b64_pool256.json").read_text())
    mix.update(batch=2, in_flight=3)
    (pb / "mixes" / "resident_b2_new.json").write_text(json.dumps(mix))
    (pb / "metrics" / "batches_done.new.py").write_text(
        "def read(rec):\n    return float(len(rec['batches']))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "boxblur_r5_new", "source": "test",
                             "file": "portbench/configs/boxblur_r5_new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "boxblur_r5.new", "config": "boxblur_r5_new",
                               "traffic": "resident_b2_new", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "batches_done.new", "unit": "batches",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["boxblur_r5.new"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json, time; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
            "from portbench import harness;"
            "r = harness.run_cell(Path(sys.argv[1]), 'boxblur_r5.new', 3, 1.5, False,"
            " time.perf_counter(), device='cpu'); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=str(REPO))   # the program, not the benchmark
    out = subprocess.run([sys.executable, "-c", code, str(tiny_root)], capture_output=True,
                         text=True, timeout=600, env=env, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert r["metrics"]["batches_done.new"]["value"] > 0


def test_the_command_fails_without_a_cuda_device_and_prints_no_result(tiny_root):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tiny_root)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(card, cell):
    r = harness.run_cell(REPO, cell, SEED, 3.0, False, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
