"""BENCHMARK.json and every file a cell names: they load, and names,
units and texts keep the contract's characters and lengths."""

import json
import re

import pytest

from benchmark import harness, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark_file()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    raw = (harness.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 << 10
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_texts():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_entries_have_only_their_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for key, keys in allowed.items():
        for entry in BENCH[key]:
            assert set(entry) <= keys, entry
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_resolves_with_its_files():
    used = set()
    for w in BENCH["workloads"]:
        cell = harness.resolve_cell(BENCH, w["name"])
        used.add(w["config"])
        harness.runner(cell["traffic"]["runner"])
        assert cell["limits"], f"{w['name']} has no limits file"
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])
        weights.model_dims(cell["config"])
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("n_layer", "n_embd", "n_head", "n_ctx", "vocab_size"):
        assert isinstance(cfg[key], int)
    assert cfg["n_embd"] % cfg["n_head"] == 0
    assert cfg["assumed"]["padded_vocab_size"] >= cfg["vocab_size"]


def test_paths_hold_only_name_characters():
    for path in (harness.HERE).rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
