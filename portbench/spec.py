"""The benchmark's description and the files it names, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations, the
cells (``workloads``) and the metrics.  Everything that belongs to one of
them is a file of its own, found by its name and never listed in code:

* ``portbench/configs/<config>.json``: the filter call and its arguments, the
  format, plane shapes, the compared numbers' limits (its path is the
  configuration's ``file``);
* ``portbench/mixes/<traffic>.json``: a traffic mix (``mode`` resident or
  streamed, batch, pool of frames, batches in flight, sampled batches, the
  traced slice);
* ``portbench/reference/<reference>.py``: the plain reference of an op, named
  by the configuration's ``reference``;
* ``portbench/metrics/<metric>.py``: one reader per metric, ``read(rec)``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

MODES = ("resident", "streamed")


class SpecError(ValueError):
    """The benchmark's description or one of its files is malformed."""


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(root: Path, bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of cell `workload`."""
    w = _entry(bench["workloads"], workload, "workload")
    c = _entry(bench["configs"], w["config"], "configuration")
    cfg = json.loads((root / c["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes" / f"{w['traffic']}.json").read_text())
    if mix.get("mode") not in MODES:
        raise SpecError(f"traffic {w['traffic']}: mode must be one of {MODES}")
    if mix["pool"] % mix["batch"]:
        raise SpecError(f"traffic {w['traffic']}: the pool must hold whole batches")
    return w, cfg, mix


def metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: end-to-end ones without
    tracing, per-layer ones with it; a metric with a ``workloads`` list only
    in those cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def load_file(root: Path, kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` under `root`."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no file {path.relative_to(root)} for {name!r}")
    modname = f"portbench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return sys.modules[modname]

