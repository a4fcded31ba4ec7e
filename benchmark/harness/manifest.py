"""``BENCHMARK.json`` and the files the harness finds by name in it.

A cell names a configuration and a traffic mix; the configuration's file
(``configs/<config>.json``) names its plain reference
(``references/<reference>.py``); the traffic mix (``workloads/<traffic>.json``)
names the program's entry point that serves it (``entries/<entry>.py``);
each per-layer metric is read by ``metrics/<name>.py``.  Adding a cell, a
mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
END_TO_END_SOURCES = {"host_clock", "device_trace"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's directory."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(manifest: dict, workload: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in manifest[kind] if "workloads" not in m or workload in m["workloads"]]


def problems(manifest: dict, root: Path = ROOT) -> list[str]:
    """What in the manifest breaks the benchmark's rules of form."""
    out = []
    names = lambda items: [i["name"] for i in items]  # noqa: E731
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = names(manifest[kind])
        out += [f"{kind}: bad name {n!r}" for n in seen if not NAME.match(n)]
        out += [f"{kind}: {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    metric_names = names(manifest["end_to_end"]) + names(manifest["per_layer"])
    out += [f"metric {n!r} twice" for n in set(metric_names) if metric_names.count(n) > 1]
    configs = set(names(manifest["configs"]))
    cells = set(names(manifest["workloads"]))
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    out += [f"pair {p} twice" for p in set(pairs) if pairs.count(p) > 1]
    for w in manifest["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        if not NAME.match(w["traffic"]) or not (BENCH_DIR / "workloads" / f"{w['traffic']}.json").is_file():
            out.append(f"{w['name']}: no traffic file for {w['traffic']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        if not 1 <= len(w["why"]) <= 200:
            out.append(f"{w['name']}: why of {len(w['why'])} characters")
        if "setup_s" not in [m["name"] for m in metrics_of(manifest, w["name"], "end_to_end")]:
            out.append(f"{w['name']}: no setup_s")
        if not metrics_of(manifest, w["name"], "per_layer"):
            out.append(f"{w['name']}: no per-layer metric")
    for c in manifest["configs"]:
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        out += [f"config {c['name']}: bad reduced key {k!r}" for k in c["reduced"] if not NAME.match(k)]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
        out += [f"{m['name']}: unknown cell {w!r}" for w in m.get("workloads", []) if w not in cells]
    for m in manifest["end_to_end"]:
        if m["source"] not in END_TO_END_SOURCES:
            out.append(f"{m['name']}: an end-to-end metric from {m['source']!r}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']!r}")
        if not (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
        reporting = {w for w in cells if m["moves"] in e2e
                     and ("workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"])}
        out += [f"{m['name']}: {w!r} does not report {m['moves']!r}"
                for w in m.get("workloads", []) if w in cells and w not in reporting]
    return out
