"""BENCHMARK.json against the contract's shapes, and every file it names
found by name."""
import json
import re
from pathlib import Path

import pytest

from benchlib.cell import Cell, port_config

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32
    assert (ROOT / SPEC["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units_use_allowed_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_bounds_and_setup_metric():
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_and_reports_enough(wl):
    cell = Cell.load(ROOT, wl["name"])
    assert wl["chips"] == 1
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell.per_layer()
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(cell.reader(m["name"]).read)
    assert (BENCH / "drivers" / f"{cell.traffic['kind']}.py").is_file()
    assert cell.limits and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    assert (ROOT / cfg["file"]).is_file()
    assert cfg["file"].startswith("bench/configs/")
    entry = json.loads((ROOT / cfg["file"]).read_text())
    assert entry["name"] == cfg["name"]
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]
    assert (BENCH / "families" / f"{entry['family']}.py").is_file()
    # a departure names a published key and the value the port runs
    assert set(entry.get("departures", {})) <= set(entry)
    mc = port_config(entry)
    for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
              "vocab_size"):
        assert entry[k] > 0
    assert mc.d_model == entry["hidden_size"]
    assert mc.n_layers == entry["num_hidden_layers"]
    assert mc.vocab == entry["vocab_size"]
    widths = re.compile(r"(hidden|intermediate|latent|state|projection|"
                        r"_dim$|_rank$|head|expand|per_tok)")
    assert not [k for k in cfg["reduced"] if widths.search(k)]


def test_per_layer_metrics_name_one_layer_each():
    layers = {}
    for m in SPEC["per_layer"]:
        assert "\n" not in m["layer"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
