"""BENCHMARK.json against the rules a manifest keeps: names, units, keys,
the files it names, a reader for every per-layer metric, the limits of
every compared number."""
import json
import os
import re

import pytest

from benchmark.harness.common import BENCH_DIR, ROOT, manifest
from benchmark.run import reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest()


def test_top_level_keys_and_size(m):
    assert set(m) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    assert m["command"][:3] == ["python3", "-m", "benchmark.run"]


def test_names_and_units(m):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES


def test_text_fields(m):
    for x in m["configs"] + m["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for c in m["configs"]:
        assert 1 <= len(c["source"]) <= 200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entry_keys(m, kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[kind]
    for x in m[kind]:
        assert set(x) - {"workloads"} == keys, x


def test_cells_files_and_limits(m):
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        assert w["chips"] == 1
        conf = configs[w["config"]]
        assert os.path.isfile(os.path.join(ROOT, conf["file"]))
        assert conf["file"].startswith("benchmark/")
        with open(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.isfile(os.path.join(BENCH_DIR, "kinds", traffic["kind"] + ".py"))
        assert os.path.isfile(os.path.join(BENCH_DIR, "problems", traffic["problems"] + ".py"))
        assert traffic["limits"]
    assert {w["config"] for w in m["workloads"]} == set(configs)


def test_bounds_and_coverage(m):
    names = {w["name"] for w in m["workloads"]}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for w in names:
        reports = [e for e in m["end_to_end"] if w in e.get("workloads", names)]
        assert any(e["name"] == "setup_s" for e in reports)
        assert len(reports) >= 2
        assert any(w in p.get("workloads", names) for p in m["per_layer"])
    for p in m["per_layer"]:
        assert p["moves"] in e2e
        for w in p.get("workloads", names):
            assert w in e2e[p["moves"]].get("workloads", names)


def test_every_per_layer_metric_has_a_reader(m):
    for p in m["per_layer"]:
        assert callable(reader(p["name"]))


def test_layers_are_named_in_perf_md(m):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        text = f.read()
    for p in m["per_layer"]:
        assert f"| {p['layer']} |" in text, p["layer"]


def test_roofline_and_mfu_names(m):
    for p in m["per_layer"]:
        if "roofline" in p["name"]:
            assert p["name"].split(".")[0].endswith("_roofline") and p["unit"] == "%"
    assert any("mfu" in p["name"] for p in m["per_layer"])
