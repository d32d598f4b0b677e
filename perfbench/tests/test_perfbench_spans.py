"""The engine dispatch reader ``syncs_per_job`` on a trace made here by hand,
whose answer is known, and on the traces recorded on the card, whose counts
the port's code gives: it counts the device-to-host copies the device ran,
whatever ranges the program put around them."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import harness  # noqa: E402
from perfbench.tests.test_perfbench_metrics import FIXTURES, recorded  # noqa: E402
from perfbench.trace import Trace, View  # noqa: E402

# a job's blocking reads by the port's code (`_to_host`: one copy a tuple
# element): the enrollment's embedding 1 and transcript 2, OSD 1, the fused
# overlap path 4 (scores, best, ids, n) or clean path 3, the target spans 2
COPIES = {"tse3-overlap": 10, "mf2-overlap": 10, "tse3-clean": 9}


def hand_made() -> View:
    """Two jobs in a 10 ms window: three device-to-host copies (pageable and
    pinned), beside kernels, a host-to-device and a device-to-device copy,
    a set, and two wait ranges the copies do not match."""
    t = Trace(
        ops=[("k", 1000, 2000), ("Memcpy HtoD (Pinned -> Device)", 2000, 2100),
             ("Memcpy DtoH (Device -> Pageable)", 2200, 2300),
             ("Memcpy DtoD (Device -> Device)", 2300, 2400), ("Memset (Device)", 2400, 2500),
             ("Memcpy DtoH (Device -> Pageable)", 5000, 5050),
             ("Memcpy DtoH (Device -> Pinned)", 9000, 9050)],
        device_ranges={"engine.asr": [(1000, 2000)]},
        host_ranges={"perfbench.window": [(0, 10000)], "engine.asr": [(900, 2000)],
                     "engine.wait.asr": [(2150, 2350), (4900, 5100)]})
    return View(t, 2, 0.010, 0.008, {}, 0.0, None)


def read(view):
    return harness.load_reader("syncs_per_job")(view)


def test_syncs_per_job_counts_the_device_to_host_copies_of_a_hand_made_trace():
    assert read(hand_made()) == 1.5


def test_syncs_per_job_does_not_read_the_programs_ranges():
    v = hand_made()
    bare = dataclasses.replace(v, trace=dataclasses.replace(
        v.trace, device_ranges={}, host_ranges={"perfbench.window": [(0, 10000)]}))
    assert read(bare) == read(v) == 1.5


def test_syncs_per_job_reads_none_without_a_device_operation_or_a_job():
    v = hand_made()
    assert read(dataclasses.replace(v, trace=dataclasses.replace(v.trace, ops=[]))) is None
    assert read(dataclasses.replace(v, jobs=0)) is None
    kernels_only = dataclasses.replace(v, trace=dataclasses.replace(v.trace, ops=[("k", 0, 1)]))
    assert read(kernels_only) == 0.0


@pytest.mark.parametrize("path", FIXTURES, ids=[p.name for p in FIXTURES])
def test_syncs_per_job_on_each_recorded_trace_is_the_count_the_code_gives(path):
    cell, view = recorded(path)
    assert read(view) == COPIES[cell]
