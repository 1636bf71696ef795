"""Nothing the benchmark runs imports JAX or the JAX package ``vszip_tpu``,
by top-level module names compared whole (``vszip_tpu_torch`` is the program
and is allowed)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench import imports

from .conftest import REPO


def test_no_module_under_portbench_imports_jax_or_the_jax_package():
    assert imports.in_sources(REPO / "portbench") == []


def test_the_source_check_compares_whole_top_level_names(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "a.py").write_text("import vszip_tpu_torch\nfrom vszip_tpu_torch.ops import boxblur\n")
    (pkg / "b.py").write_text("import jax.numpy as jnp\nfrom vszip_tpu.core import clip\n")
    assert imports.in_sources(pkg) == ["pkg/b.py: jax.numpy", "pkg/b.py: vszip_tpu.core"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.harness, portbench.faults, portbench.readings, portbench.run;"
            "import vszip_tpu_torch;"
            "from portbench import imports; print(imports.loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_loaded_sees_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert imports.loaded() == ["jax"]


def test_a_run_that_loads_jax_after_the_window_prints_no_result(tiny_root, tmp_path):
    """A metric's reader, loaded after the window, imports a module named
    ``jax`` (a stub here): the run ends without a result and names it."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    pb = tiny_root / "portbench"
    (pb / "metrics" / "loads_jax.py").write_text("import jax  # noqa: F401\n\n\n"
                                                "def read(rec):\n    return 1.0\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    bench["end_to_end"].append({"name": "loads_jax", "unit": "s", "better": "lower",
                                "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json, time; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
            "from portbench import harness;"
            f"r = harness.run_cell(Path(sys.argv[1]), {cell!r}, 3, 0.3, False,"
            " time.perf_counter(), device='cpu'); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=f"{stub}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code, str(tiny_root)], capture_output=True,
                         text=True, timeout=600, env=env, cwd=tiny_root)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "portbench: loaded by the end of the run: jax" in out.stderr
