"""BENCHMARK.json against the contract's names, units and limits, and every
name it holds against the file that carries it."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
          "experts_per_token", "num_carriers", "fft_size", "samples_per_symbol", "cp_len")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"]
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"]
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m["name"]
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names(name):
    assert NAME.match(name), name


def test_units_sources_and_lines():
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for item in BENCH["configs"] + BENCH["workloads"]:
        assert _line(item["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and c["source"].startswith("https://")
    assert all(_line(word) for word in BENCH["command"]) and len(BENCH["command"]) <= 32


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_paths_and_command():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_has_its_file():
    here = ROOT / "benchmark"
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert not any(w in k for k in c["reduced"] for w in WIDTHS)
    for w in BENCH["workloads"]:
        cell = json.loads((here / "workloads" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        assert (here / "generators" / f"{traffic['generator']}.py").is_file()
        assert (here / "entries" / f"{traffic['entry']}.py").is_file()
        assert w["chips"] in (1, 4)
    for m in METRICS:
        assert (here / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_cells_report_what_the_contract_asks():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for cell in cells:
        reported = {n for n, ws in e2e.items() if cell in ws}
        assert len(reported - {"setup_s"}) >= 1
        layer = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
        assert layer, cell
        for m in layer:
            assert m["moves"] in reported, (cell, m["name"])
    for m in BENCH["per_layer"]:
        # The harness picks a per-layer metric's cells by its list alone.
        assert m["moves"] in e2e and m["workloads"]
        assert set(m["workloads"]) <= cells
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(_line(layer) for layer in layers)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer
