"""Whole runs of the harness on the CPU at tiny widths: a job of each cell's
traffic through the port's CPU twins comes out correct; with the timed path
broken underneath (half the batch left out, a token altered where it is
produced, a score, the record's branch or the branch transcribed altered
where it is produced)
``correct`` comes out
false; the control (the reference one precision below float32) fails the
cell's limits; and the entry point refuses to run without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import check, harness, traffic  # noqa: E402
from perfbench.reference.pipeline import Reference  # noqa: E402

TINY = Path(__file__).resolve().parent / "tiny"
MANIFEST = harness.load_manifest()
SEED = 2**31 + 101


def tiny_cell(name: str, **traffic_overrides) -> harness.Cell:
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    sep = harness.load_config(entry["config"])["sep_backend"]
    cfg = json.loads((TINY / f"tiny-{sep}.json").read_text())
    wl = dict(traffic.load_workload(entry["traffic"]), pool_jobs=1, warm_jobs=1, check_jobs=1,
              **traffic_overrides)
    mine = lambda m: "workloads" not in m or name in m["workloads"]  # noqa: E731
    return harness.Cell(name, cfg, wl, check.load_limits(name, harness.HERE),
                        [m for m in MANIFEST["end_to_end"] if mine(m)],
                        [m for m in MANIFEST["per_layer"] if mine(m)])


def small(name: str) -> harness.Cell:
    """The cell's traffic shortened (3 mixtures of 1-1.9 s where a job has
    several, so the last batch row is padding) for the fault runs."""
    wl = traffic.load_workload(name)
    many = wl["mixtures_per_job"] > 1
    return tiny_cell(name, mixtures_per_job=3 if many else 1, length_s=[1.0, 1.9],
                     bucket_s=2, enroll_s=1.5)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tse3-overlap", "mf2-overlap", "tse3-clean"])
def test_a_job_of_each_cells_traffic_is_correct_on_the_cpu_twins(name):
    cell = tiny_cell(name)
    res = harness.run(cell, SEED, 0.01, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(cell.limits)


def test_a_traced_run_reports_the_per_layer_metrics_it_finds():
    cell = small("tse3-overlap")
    res = harness.run(cell, SEED, 0.01, True, "cpu")
    assert res["correct"] and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not res["metrics"]  # the CPU runs no device operation: nothing to read


def _broken(monkeypatch, fault: str):
    from audio_classification_tpu_torch.engine import runtime

    if fault == "half_batch":
        orig = runtime.StageEngine._sep_core

        def sep_core(self, wav, lengths, stage="sep3"):
            est = orig(self, wav, lengths, stage)
            half = est.shape[0] // 2
            return torch.cat([est[:est.shape[0] - half], est[:half]])
        monkeypatch.setattr(runtime.StageEngine, "_sep_core", sep_core)
    elif fault == "token":
        orig = runtime.ctc_greedy_decode

        def decode(logits, mask, blank_id=0):
            ids, n = orig(logits, mask, blank_id)
            ids = ids.clone()
            ids[:, 0] = ids[:, 0] % (logits.shape[-1] - 1) + 1
            return ids, torch.clamp_min(n, 1)
        monkeypatch.setattr(runtime, "ctc_greedy_decode", decode)
    elif fault == "answer":
        orig = runtime.StageEngine._overlap_path_fn

        def overlap(self, *a, **k):
            scores, *rest = orig(self, *a, **k)
            return (scores + 0.01, *rest)
        monkeypatch.setattr(runtime.StageEngine, "_overlap_path_fn", overlap)
    elif fault == "stream":
        from audio_classification_tpu_torch.pipelines import offline_overlap3

        orig = offline_overlap3.Overlap3Pipeline._gate_row

        def gate_row(self, mx, r, *a):
            orig(self, mx, r, *a)
            if "best_branch" in r:  # the record names its worst branch, with its score
                worst = min(r["branch_scores"], key=r["branch_scores"].get)
                r["best_branch"], r["sv_score"] = worst, r["branch_scores"][worst]
        monkeypatch.setattr(offline_overlap3.Overlap3Pipeline, "_gate_row", gate_row)
    elif fault == "branch":
        # each record's transcript made from another record's chosen branch
        monkeypatch.setattr(runtime.StageEngine, "_branch_norm",
                            lambda self, rows: rows.roll(1, dims=0))


@pytest.mark.parametrize("fault", ["none", "half_batch", "token", "answer", "stream", "branch"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    cell = small("tse3-overlap")
    if fault != "none":
        _broken(monkeypatch, fault)
    res = harness.run(cell, SEED, 0.01, False, "cpu")
    assert res["correct"] == (fault == "none"), res["checks"]
    failing = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert bool(failing) == (fault != "none")
    assert {"none": "", "half_batch": "emb", "token": "text", "answer": "sv_score",
            "stream": "stream", "branch": "logits"}[fault] in (failing | {""})


@pytest.mark.parametrize("name", ["tse3-overlap", "mf2-overlap", "tse3-clean"])
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_control_fails_the_cells_limits(name, seed):
    """The reference with every product in TF32, in the program's place."""
    cell = small(name)
    cfg, wl = cell.config, cell.workload
    job = traffic.make_jobs(wl, seed)[0]
    symbols = cell.asr.token_symbols(cfg["preset"][cell.asr.PRESET])
    ref = harness.reference_for(cfg, wl, seed, "cpu", symbols, cell.asr)
    ctl = Reference(cfg, ref.w, ref.pn, symbols, "cpu", cell.asr, tf32=True)
    side = ctl.run_job(job.mixtures, job.target, wl["kind"])
    follow = [r["stream"] for r in side["records"]] if wl["kind"] == "overlap" else None
    numbers = check.compare_job(side, ref.run_job(job.mixtures, job.target, wl["kind"], follow,
                                                  side["asr"]), len(job.mixtures))
    assert not check.judge(numbers, cell.limits), numbers


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    for where in (ROOT, tmp_path):
        if where == tmp_path:  # BENCHMARK.json and perfbench alone
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "tse3-overlap",
                            "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                           cwd=where, capture_output=True, text=True, timeout=300,
                           env={**os.environ, "BENCH_RUN": "x"})
        assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "tse3-overlap",
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
