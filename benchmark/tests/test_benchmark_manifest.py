"""BENCHMARK.json keeps to its rules of form, and every name it holds
finds its file."""

import json
import re

import pytest

from harness import manifest

MAN = manifest.load()


def test_no_problems():
    assert manifest.problems(MAN) == []


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entry_keys(kind, keys):
    for item in MAN[kind]:
        assert set(item) <= keys, item
        assert set(item) >= keys - {"workloads"}, item


def test_names_and_units():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in MAN[kind]:
            assert manifest.NAME.match(item["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
    assert manifest.problems({**MAN, "per_layer": [{**MAN["per_layer"][0], "unit": "syncs per req"}]})
    assert manifest.problems({**MAN, "workloads": MAN["workloads"] + [MAN["workloads"][0]]})


def test_every_cell_reports_the_required_metrics():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(MAN, w["name"], "end_to_end")}
        assert {"setup_s", "audio_s_per_s", "request_ms_p95", "peak_mem_mib"} <= e2e
        assert manifest.metrics_of(MAN, w["name"], "per_layer")


def test_files_found_by_name():
    for w in MAN["workloads"]:
        mix = manifest.traffic(w["traffic"])
        cfg = manifest.config(MAN, w["config"])
        assert manifest.module("entries", mix["entry"]).Entry
        assert manifest.module("references", cfg["reference"]).decode
    for m in MAN["per_layer"]:
        assert manifest.module("metrics", m["name"]).read


def test_config_files_state_the_source():
    for c in MAN["configs"]:
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["precision"] == "float32"
        assert set(data["limits"]) == {"frames_differ", "corr_gap"}
        assert re.match(r"https://", c["source"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_one_chip_cells():
    assert all(w["chips"] == 1 for w in MAN["workloads"])
