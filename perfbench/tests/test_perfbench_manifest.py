"""BENCHMARK.json against the benchmark's contract: names, units, keys, and
that every file a cell is found by exists."""
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))
from perfbench import harness  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_names()), ids=lambda x: x if isinstance(x, str)
                         else x.get("name"))
def test_names_units_and_lines(key, entry):
    assert NAME.match(entry["name"])
    if key in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    if key == "end_to_end":
        assert set(entry) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert set(entry) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(entry["layer"])
        assert entry["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        assert (HERE / "metrics" / f"{entry['name']}.py").is_file()
        if "roofline" in entry["name"] or "mfu" in entry["name"]:
            assert entry["unit"] == "%"
    if key == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(entry["source"]) and LINE.match(entry["why"])
        assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
        assert (ROOT / entry["file"]).is_file()
        assert all(NAME.match(k) for k in entry["reduced"])
    if key == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] == 1 and LINE.match(entry["why"])
        assert NAME.match(entry["traffic"]) and NAME.match(entry["config"])
        assert (HERE / "workloads" / f"{entry['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{entry['name']}.json").is_file()


def test_every_cell_reports_what_the_contract_asks():
    e2e = MANIFEST["end_to_end"]
    assert "setup_s" in {m["name"] for m in e2e}
    assert next(m for m in e2e if m["name"] == "setup_s")["bound"] <= 0.25
    configs = {c["name"] for c in MANIFEST["configs"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert configs == {w["config"] for w in MANIFEST["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(cells)
    for cell in cells:
        mine = lambda m: "workloads" not in m or cell in m["workloads"]  # noqa: E731
        ends = [m["name"] for m in e2e if mine(m)]
        assert "setup_s" in ends and len(ends) >= 2
        layers = [m for m in MANIFEST["per_layer"] if mine(m)]
        assert layers and all(m["moves"] in ends for m in layers)
    for m in MANIFEST["per_layer"] + e2e:
        assert set(m.get("workloads", [])) <= cells


def test_names_are_unique_and_layers_consistent():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_state_their_widths_and_cuts():
    for entry in MANIFEST["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"] == []
        assert cfg["dtype"] == "float32" and "assumed" in cfg and cfg["departures"]
        fam = harness.load_family(harness.family_name(cfg))  # the recognizer's published widths
        asr = cfg["preset"][fam.PRESET]
        assert fam.PUBLISHED and {k: asr[k] for k in fam.PUBLISHED} == fam.PUBLISHED
        assert cfg["pyannet"]["layers"] == 4 and cfg["pyannet"]["hidden"] == 128
