"""Each per-layer reader on traces recorded on the card (one traced job of
each cell, trimmed: ``perfbench/readings.py --fixture``) and on a trace made
here by hand, whose answers are known."""
import dataclasses
import gzip
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import harness  # noqa: E402
from perfbench.trace import Trace, View  # noqa: E402

FIXTURES = sorted((Path(__file__).resolve().parent / "fixtures").glob("*.json.gz"))
MANIFEST = harness.load_manifest()
H100 = {"tf32_flops": 495e12, "hbm_bytes": 3.35e12}


def recorded(path: Path) -> tuple:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        d = json.load(f)
    view = View(Trace.from_dict(d["trace"]), d["jobs"], d["window_s"], d["untraced_s"],
                d["calls"], d["flops"], harness.peaks_for(d["kind"]))
    return d["cell"], view


@pytest.mark.parametrize("path", FIXTURES, ids=[p.name for p in FIXTURES])
def test_every_reader_reads_what_its_cell_lists_on_a_recorded_trace(path):
    cell, view = recorded(path)
    assert view.peaks is not None
    for m in MANIFEST["per_layer"]:
        value = harness.load_reader(m["name"])(view)
        if cell in m.get("workloads", [cell]):
            assert value is not None and value > 0, m["name"]
            if m["unit"] == "%":
                assert value <= 100.0, (m["name"], value)
        else:
            assert value is None, m["name"]


def hand_made() -> View:
    """Two jobs in a 10 ms traced window that took 8 ms without the profiler:
    four kernels (two inside a perfbench.k2 range, one inside engine.osd), a
    copy, and the host inside engine.asr while the device idles."""
    t = Trace(
        ops=[("k2_gemm", 1000, 2000), ("k2_dw", 2000, 3000), ("osd_lstm", 4000, 5000),
             ("memcpy", 5000, 5500), ("asr_gemm", 8000, 9000)],
        device_ranges={"perfbench.k2": [(1000, 3000)], "engine.osd": [(4000, 5000)],
                       "engine.overlap": [(1000, 3000)]},
        host_ranges={"perfbench.window": [(0, 10000)], "engine.asr": [(5500, 9000)],
                     "engine.overlap": [(0, 3000)]})
    calls = {"k2": [{"flops": 495e12 * 1e-3, "bytes": 0.0}]}  # 1 ms at the peak
    return View(t, 2, 0.010, 0.008, calls, 495e12 * 2e-3, H100)


def test_the_readers_on_a_hand_made_trace():
    v = hand_made()
    read = lambda name: harness.load_reader(name)(v)  # noqa: E731
    assert read("device_ops_per_job") == 2.5
    assert read("stage_device_ms.osd") == pytest.approx(0.5)
    assert read("stage_device_ms.overlap") == pytest.approx(1.0)
    assert read("stage_device_ms.clean") is None
    assert read("k2_roofline") == pytest.approx(50.0)
    assert read("k3_roofline") is None and read("k4_roofline") is None
    assert read("mfu") == pytest.approx(25.0)
    assert read("idle_share") == pytest.approx(43.75)
    no_pass = dataclasses.replace(v, untraced_s=None)
    assert harness.load_reader("mfu")(no_pass) is None
    assert harness.load_reader("idle_share")(no_pass) is None
    assert v.trace.top_ops(2) == [["k2_gemm", 1e-3], ["k2_dw", 1e-3]]
    gaps = dict(v.trace.idle_gaps())
    assert gaps["engine.asr"] == pytest.approx(2.5e-3)
    assert gaps["engine.overlap"] == pytest.approx(1e-3)
    assert sum(gaps.values()) == pytest.approx(5.5e-3)


def test_a_trace_round_trips_through_plain_data():
    v = hand_made()
    again = Trace.from_dict(json.loads(json.dumps(v.trace.to_dict())))
    assert again == v.trace
