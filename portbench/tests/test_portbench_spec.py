"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds its
files by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|width|height|hidden|intermediate|latent|state|projection|head")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units_use_only_the_allowed_characters():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            assert NAME.match(e["name"]), e["name"]
            assert "unit" not in e or UNIT.match(e["unit"]), e["unit"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(r) for r in c["reduced"])
    names = [e["name"] for k in ("end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])


@pytest.mark.parametrize("kind,entries", [
    ("config", BENCH["configs"]), ("workload", BENCH["workloads"]),
    ("end_to_end", BENCH["end_to_end"]), ("per_layer", BENCH["per_layer"])])
def test_entries_have_just_the_contract_keys(kind, entries):
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks():
    cells = [w["name"] for w in BENCH["workloads"]]
    for w in cells:
        e2e = [m["name"] for m in spec.metrics(BENCH, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w
        per_layer = spec.metrics(BENCH, w, True)
        assert per_layer, w
        for m in per_layer:
            assert m["moves"] in e2e, (w, m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_workloads_pairs_chips_and_configs():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert not any(WIDTHS.search(k) for k in c["reduced"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(workload):
    w, cfg, mix = spec.cell(REPO, BENCH, workload)
    assert cfg["name"] == w["config"]
    ref = spec.load_file(REPO, "reference", cfg["reference"])
    assert callable(ref.score if "compare" in cfg else ref.run) and callable(ref.work)
    for m in spec.metrics(BENCH, workload, False) + spec.metrics(BENCH, workload, True):
        assert callable(spec.load_file(REPO, "metrics", m["name"]).read)
    assert mix["pool"] % mix["batch"] == 0
    if "compare" in cfg:
        # a metric op: two clips in, frame props out, compared under a score limit
        assert cfg["compare"]["props"] and set(cfg["limits"]) == {"max_abs_score"}
        assert mix["mode"] == "resident"
        assert {"blur", "quant", "noise"} <= set(cfg["distorted"])
    else:
        assert set(cfg["limits"]) == {"max_abs_lsb", "off_share_pct"}


def test_a_missing_file_is_named():
    with pytest.raises(spec.SpecError, match="no file"):
        spec.load_file(REPO, "metrics", "no_such_metric")
