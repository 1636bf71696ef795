"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark.

``tiny_root`` copies ``BENCHMARK.json`` and ``portbench/`` into a temporary
checkout root with every configuration cut to 96x64 pictures and every
traffic mix to batches of 4 frames, so a whole run of a cell takes about a
second on the CPU through the program's CPU path.  The copy also holds the
streamed cell, so the harness's streamed driver is tested though no cell of
``BENCHMARK.json`` uses it yet.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"width": 96, "height": 64, "planes": [[64, 96], [32, 48], [32, 48]]}


def make_tiny(dst: Path) -> Path:
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = dst / c["file"]
        p.write_text(json.dumps({**json.loads(p.read_text()), **TINY}))
    for p in (dst / "portbench" / "mixes").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(batch=4, pool=12, warmup=3, sample=3, trace_seconds=0.2)
        p.write_text(json.dumps(mix))
    return dst


STREAMED = "bilateral_s2r2.streamed"


def add_streamed_cell(root: Path) -> None:
    """Adds the streamed cell that ``BENCHMARK.json`` leaves for later (Bilateral
    through ``process_stream``) to the copy at `root`, as entries only: its
    mix and its runtime readers are files already."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": STREAMED, "config": "bilateral_s2r2_yuv420p16_1080p",
                               "traffic": "streamed_b32_pool192", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(STREAMED)
    bench["per_layer"] += [
        {"name": n, "unit": u, "better": b, "source": "program_span",
         "layer": "streaming runtime (runtime/stream.py)", "moves": "frames_per_s",
         "workloads": [STREAMED]}
        for n, u, b in (("stream_fill_ms", "ms", "lower"), ("stream_h2d_gbps", "GB/s", "higher"))]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = make_tiny(tmp_path)
    add_streamed_cell(root)
    return root


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); this machine has none")
    return torch.device("cuda")
