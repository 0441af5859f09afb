"""Every cell, configuration, traffic mix and per-layer metric that
BENCHMARK.json names is found by its name, and the names and entries keep
to the benchmark's format."""
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_keeps_to_the_format():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert all(m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_a_cell_finds_its_configuration_traffic_and_driver(w):
    from portbench import run
    c = run.cell(w["name"])
    assert c["config"]["name"] == w["config"]
    driver = importlib.import_module(f"portbench.drivers.{c['traffic']['driver']}")
    assert callable(driver.run)
    assert w["chips"] == 1
    assert {"setup_s"} < {m["name"] for m in run.for_cell(SPEC["end_to_end"], w["name"])}
    assert run.for_cell(SPEC["per_layer"], w["name"])


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_a_configuration_file_states_what_it_reduced(cfg):
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_a_per_layer_metric_has_a_reader(m):
    from portbench.harness import _reader
    assert callable(_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
