"""The benchmark of ``vszip_tpu_torch`` on one NVIDIA H100: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name through ``BENCHMARK.json`` (see ``spec.py``).  The
run makes its frames from the seed on the card, warms up, measures for
``--seconds``, compares a sample of what the window produced with the plain
reference, and prints one JSON object as the last line of standard output
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones), each compared number beside its limit as the last lines of
standard error.  It refuses to run without as many CUDA devices as the cell
asks for, and fails when JAX or the JAX package ``vszip_tpu`` is loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode, like every compiler cache, is kept in the checkout at a
# fixed path, so that only a checkout's first run compiles torch's modules:
# where the installation ships no bytecode and writing it is switched off,
# every run would otherwise spend some 5 s of CPU on it
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "portbench" / "pycache")

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()

    # every compiler cache the program or torch could use stays in the
    # checkout, at a fixed path, so only a checkout's first run of a cell builds
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute_cache")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, imports, spec

    bench = spec.load(ROOT)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == a.workload), None)
    if chips is None:
        print(f"portbench: no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace), T_START)
    if a.trace:
        result["card"] = _power_limit()
        print(f"card: {result['card']}; least ms per batch {result['bound']['least_ms_per_batch']} "
              f"({result['bound']['by']})", file=sys.stderr)
    phases = result.pop("setup")
    print("set-up and check: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    for note in result.pop("trace_slices", []):
        print(f"trace slice: {note}", file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks   # the compared numbers come last
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    imports.refuse("before the result")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
