"""The recognizer family lookup (``asr_family`` -> ``asr/<family>.py``): the
SenseVoice family gives the weights, FLOPs and reference outputs that the
harness gave before the recognizer moved behind it
(``fixtures/asr_move_parent.json``, which names the cells it recorded); a
configuration without the key is SenseVoice; an unknown family fails at
load, naming its file; and a family is added by files alone. Configurations
and cells added later are not read here."""
import hashlib
import json
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE))
from perfbench import harness, traffic, weights, work  # noqa: E402
from test_perfbench_runs_cpu import MANIFEST, tiny_cell  # noqa: E402

PARENT = json.loads((HERE / "fixtures" / "asr_move_parent.json").read_text())
SEED = PARENT["seed"]
TINY = HERE / "tiny"
SV = harness.load_family("sensevoice")


@pytest.fixture
def four_threads():
    """The recorded digests were read with 4 threads: a CPU sum may split by
    the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(PARENT["weights_sha256"]))
def test_the_recognizers_weights_are_the_parents(name):
    cfg = json.loads((TINY / f"{name}.json").read_text())
    sd = weights.stage_weights("asr", cfg["preset"][SV.PRESET], SEED, "cpu", SV.spec)
    h = hashlib.sha256()
    for k, t in sd.items():
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == PARENT["weights_sha256"][name]


@pytest.mark.parametrize("key", sorted(PARENT["job_flops"]))
def test_job_flops_are_the_parents(key):
    cell, which = key.rsplit(".", 1)
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    wl = traffic.load_workload(entry["traffic"])
    cfg = harness.load_config(entry["config"])
    if which == "tiny":
        cfg = json.loads((TINY / f"tiny-{cfg['sep_backend']}.json").read_text())
    family = harness.load_family(harness.family_name(cfg))
    enroll = int(wl["enroll_s"] * traffic.SR)
    got = [work.job_flops([int(n) for n in row], enroll, cfg, wl["kind"], family)
           for row in traffic.mixture_lengths(wl, SEED)]
    assert got == PARENT["job_flops"][key]


@pytest.mark.parametrize("name", sorted(PARENT["reference_sha256"]))
def test_the_references_outputs_of_a_job_are_the_parents(four_threads, name):
    """The reference's recognizer outputs for the first job, its own branches
    chosen (no program output read), digest for digest; and the job run
    through the harness comes out correct."""
    cell = tiny_cell(name)
    cfg, wl, fam = cell.config, cell.workload, cell.asr
    cpu = torch.device("cpu")
    ref = harness.reference_for(cfg, wl, SEED, cpu, fam.token_symbols(cfg["preset"][fam.PRESET]),
                                fam)
    job = traffic.make_jobs(wl, SEED, cpu)[0]
    h = hashlib.sha256()
    for e in ref.run_job(job.mixtures, job.target, wl["kind"])["asr"]:
        for k in ("feats", "mask", "logits"):
            h.update(str(tuple(e[k].shape)).encode())
            h.update(e[k].contiguous().numpy().tobytes())
        h.update("\n".join(e["texts"]).encode())
    assert h.hexdigest() == PARENT["reference_sha256"][name]
    res = harness.run(cell, SEED, 0.01, False, "cpu")
    assert res["correct"], res["checks"]


def test_a_configuration_without_asr_family_is_sensevoice():
    assert harness.family_name({"name": "bare", "preset": {}}) == "sensevoice"
    configs = [harness.load_config(c["name"]) for c in MANIFEST["configs"]]
    configs += [json.loads(p.read_text()) for p in sorted(TINY.glob("*.json"))]
    for cfg in configs:
        if "asr_family" not in cfg:
            assert harness.family_name(cfg) == "sensevoice"
    cell = tiny_cell("tse3-clean")
    assert "asr_family" not in cell.config and cell.asr.PACK_FAMILY == "sensevoice"
    assert Path(cell.asr.__file__) == harness.HERE / "asr" / "sensevoice.py"


def test_an_unknown_family_fails_at_load_and_names_its_file(tmp_path):
    cell = tiny_cell("tse3-clean")
    with pytest.raises(SystemExit, match=r"asr/nonesuch\.py"):
        harness.Cell(cell.name, dict(cell.config, asr_family="nonesuch"), cell.workload,
                     cell.limits, cell.end_to_end, cell.per_layer)
    with pytest.raises(SystemExit, match=re.escape(str(tmp_path / "asr" / "sensevoice.py"))):
        harness.load_family("sensevoice", tmp_path)


def test_a_family_is_added_by_files_alone(tmp_path):
    """A family module and a configuration that names it, written under
    another root: the harness finds both there and a job comes out correct."""
    (tmp_path / "asr").mkdir()
    (tmp_path / "configs").mkdir()
    shutil.copy(harness.HERE / "asr" / "sensevoice.py", tmp_path / "asr" / "copied.py")
    cfg = dict(json.loads((TINY / "tiny-convtasnet.json").read_text()), name="tiny-copied",
               asr_family="copied")
    (tmp_path / "configs" / "tiny-copied.json").write_text(json.dumps(cfg))
    base = tiny_cell("tse3-clean")
    cell = harness.Cell(base.name, harness.load_config("tiny-copied", tmp_path), base.workload,
                        base.limits, base.end_to_end, base.per_layer, tmp_path)
    assert Path(cell.asr.__file__) == tmp_path / "asr" / "copied.py"
    assert cell.asr.PACK_FAMILY == "sensevoice"
    res = harness.run(cell, SEED, 0.01, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
