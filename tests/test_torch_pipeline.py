"""The PyTorch port's flagship file-mode pipeline against the JAX pipeline
(tiny preset, CPU, the same converted weights and wavs), its artifact
writers against the checked-in goldens, and its independence from JAX."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import default_buckets as jax_default_buckets
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.pipelines.offline_overlap3 import Overlap3Pipeline as JaxPipeline
from audio_classification_tpu.utils.config import Overlap3Config as JaxConfig
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli.offline_overlap_3src import main, write_artifacts
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.pipelines.offline_overlap3 import (
    Overlap3Pipeline,
    PipelineResult,
)
from audio_classification_tpu_torch.utils.config import Overlap3Config

torch.set_num_threads(2)
SR = 16000
REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "goldens" / "overlap3"


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_overlap3")
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(d / "mix.wav", mix, SR)
    write_wav(d / "target.wav", (0.3 * np.sin(2 * np.pi * 440 * t[: 2 * SR])).astype(np.float32), SR)
    return d


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, on the same tiny weights and buckets."""
    jax_pack = JaxModelPack(jax_tiny_preset(), seed=0)
    pack = ModelPack(tiny_preset(), seed=1, device="cpu")  # another seed: every weight is overwritten
    pack.load_state_dicts(params_to_state_dicts(
        {k: jax_pack.params[k] for k in ModelPack.STAGES}))
    jax_eng = JaxStageEngine(jax_pack, JaxBucketSpec(jax_default_buckets(SR, 0.5, 4.0), 4))
    eng = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 4.0), 4))
    return jax_eng, eng


def _cfg_kwargs(wavs, osd_thr):
    return dict(input_wavs=[str(wavs / "mix.wav")], target_wav=str(wavs / "target.wav"),
                preset="tiny", seed=0, sv_threshold=-1.0, max_batch=4, max_segment_sec=4.0,
                osd_thr=osd_thr)


@pytest.mark.parametrize("osd_thr,kind", [(0.0, "overlap"), (1.0, "clean")])
def test_forced_scene_matches_jax_pipeline(wavs, engines, osd_thr, kind):
    """osd_thr=0.0 forces every segment to overlap (separation -> per-branch
    SV -> best-branch ASR), 1.0 forces every segment clean (SV -> ASR):
    records must agree exactly on kind/start/end/stream/text and within 1e-4
    on sv_score (float32 path, scores rounded to 4 decimals on both sides)."""
    jax_eng, eng = engines
    ref = JaxPipeline(JaxConfig(**_cfg_kwargs(wavs, osd_thr)), engine=jax_eng).run()
    got = Overlap3Pipeline(Overlap3Config(**_cfg_kwargs(wavs, osd_thr)), engine=eng).run()
    assert len(got.segments) == len(ref.segments) >= 1
    for g, r in zip(got.segments, ref.segments):
        assert g["kind"] == kind
        for key in ("wav", "kind", "start", "end", "stream", "text", "target_src",
                    "target_src_text"):
            assert g[key] == r[key], key
        assert abs(g["sv_score"] - r["sv_score"]) <= 1e-4 + 1e-9
    for key in ("segments_total", "segments_clean", "segments_overlap_streams",
                "segments_matched", "segments_missed", "total_audio_sec"):
        assert got.metrics[key] == ref.metrics[key], key


def test_cli_writers_reproduce_goldens(tmp_path):
    from test_golden_artifacts import _overlap3_cfg, _overlap3_result

    result = PipelineResult(**dataclasses.asdict(_overlap3_result()))
    cfg = Overlap3Config(**dataclasses.asdict(_overlap3_cfg()))
    write_artifacts(tmp_path, result, cfg)
    for name in ("segments.jsonl", "segments.csv", "overlap_sep_details.csv",
                 "metrics.json", "summary.json"):
        assert (tmp_path / name).read_bytes() == (GOLDEN / name).read_bytes(), name


def test_cli_main_file_mode_writes_artifacts(wavs, tmp_path):
    out_dir, result = main(["--input-wavs", str(wavs / "mix.wav"), "--target-wav",
                            str(wavs / "target.wav"), "--preset", "tiny", "--seed", "0",
                            "--sv-threshold", "-1", "--max-segment-sec", "4",
                            "--provider", "cpu", "--out-dir", str(tmp_path)])
    recs = [json.loads(line) for line in (out_dir / "segments.jsonl").read_text().splitlines()]
    assert len(recs) == result.metrics["segments_total"] >= 1
    assert (out_dir / "segments.csv").is_file()
    summary = json.loads((out_dir / "summary.json").read_text())
    assert summary["dataset"] == "manual-files" and summary["segments"] == len(recs)


_NOT_READ = (NotImplementedError, "not ported")
_TORCHRUN = (ValueError, "one rank per card: torchrun --nproc-per-node 2")


@pytest.mark.parametrize("flags,refusal", [
    (["--sense-voice", "ORBAX_DIR"], _NOT_READ), (["--osd-checkpoint", "ORBAX_DIR"], _NOT_READ),
    (["--model-parallel", "2"], _TORCHRUN), (["--data-parallel", "2"], _TORCHRUN),
    (["--arena-codec", "mulaw"], None), (["--spk-embed-model", "ORBAX_DIR"], _NOT_READ),
    (["--slices", "2"], None), (["--checkpoint-dir", "ORBAX_DIR"], _NOT_READ),
])
def test_unported_flags_raise(wavs, tmp_path, flags, refusal):
    """Weights the port does not read raise NotImplementedError (.onnx model
    files load since the ONNX slice: tests/test_torch_onnx_stage.py). A mesh
    over several cards is one torchrun rank per card, so --data-parallel /
    --model-parallel above 1 in one process raise with the command to run
    (tests/test_torch_mesh_ranks.py runs them over gloo ranks);
    --arena-codec mulaw runs, and --slices without a mesh does nothing, as
    in JAX."""
    # a directory an orbax checkpointer wrote (the port's own loads)
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    flags = [str(tmp_path / "orbax") if f == "ORBAX_DIR" else f for f in flags]
    argv = ["--input-wavs", str(wavs / "mix.wav"), "--target-wav", str(wavs / "target.wav"),
            "--preset", "tiny", "--provider", "cpu", "--out-dir", str(tmp_path / "out"), *flags]
    if refusal is None:
        out_dir, result = main(argv)
        assert (out_dir / "segments.jsonl").is_file() and result.metrics["segments_total"] >= 1
        return
    with pytest.raises(refusal[0], match=refusal[1]):
        main(argv)


def test_dataset_mode_and_resampling_raise(wavs, engines, tmp_path):
    """Dataset mode and non-16 kHz input are ported now: neither raises
    NotImplementedError any more. Dataset mode on a directory without a
    LibriMix tree says which directory it missed, and an 8 kHz mixture is
    resampled and runs through the pipeline."""
    with pytest.raises(FileNotFoundError, match="LibriMix mix dir not found"):
        main(["--librimix-root", str(tmp_path), "--preset", "tiny", "--provider", "cpu"])
    t = np.arange(8000) / 8000.0
    write_wav(tmp_path / "mix8k.wav", (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), 8000)
    cfg = Overlap3Config(**{**_cfg_kwargs(wavs, 0.5), "input_wavs": [str(tmp_path / "mix8k.wav")]})
    result = Overlap3Pipeline(cfg, engine=engines[1]).run()
    assert result.metrics["total_audio_sec"] == 1.0  # 8000 samples at 8 kHz -> 16000 at 16 kHz


def test_build_engine_without_a_card_raises():
    """The card is the default device: with no device named and no CUDA
    device present, build_engine, ModelPack and the CLI raise instead of
    carrying on on the CPU."""
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists here")
    cfg = Overlap3Config(preset="tiny", seed=0)
    assert cfg.provider == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelPack(tiny_preset(), seed=0)
    assert build_engine(cfg, device="cpu").device.type == "cpu"
    assert build_engine(Overlap3Config(preset="tiny", provider="cpu")).device.type == "cpu"
    with pytest.raises(ValueError, match="--provider"):
        build_engine(Overlap3Config(preset="tiny", provider="tpu"))


def test_port_imports_without_jax():
    """Every module of the port imports with jax and flax unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import audio_classification_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("flags", [{"fused_paths": False}, {"device_gather": False}])
def test_granular_and_host_upload_paths_match_jax(wavs, engines, flags):
    """--no-fused-paths (separate, embed and transcribe stage by stage; the
    separated branches go through the int16 upload before SV and ASR) and
    --no-device-gather (per-batch uploads instead of the arena) against the
    JAX pipeline with the same flag, both forced scenes, same tolerances."""
    jax_eng, eng = engines
    for thr in (0.0, 1.0):
        ref = JaxPipeline(JaxConfig(**_cfg_kwargs(wavs, thr), **flags), engine=jax_eng).run()
        got = Overlap3Pipeline(Overlap3Config(**_cfg_kwargs(wavs, thr), **flags),
                               engine=eng).run()
        assert len(got.segments) == len(ref.segments) >= 1
        for g, r in zip(got.segments, ref.segments):
            for key in ("kind", "start", "end", "stream", "text", "target_src_text"):
                assert g[key] == r[key], key
            assert abs(g["sv_score"] - r["sv_score"]) <= 1e-4 + 1e-9


def test_transcribe_branches_matches_host_round_trip(engines):
    """Device-side branch ASR (the int16 batch assembled from the separated
    branches on the device) equals separating, pulling the branches to the
    host and transcribing them."""
    eng = engines[1]
    rng = np.random.default_rng(3)
    chunks = [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in (9000, 20000)]
    target = eng.embed([chunks[0]])[0]
    handle = eng.launch_overlap(chunks, [target, target], return_branches=True)
    recs = eng.collect_overlap(handle, chunks, return_branches=True, lazy_branches=True)
    refs = [rec["branches"].ref(bi) for rec in recs for bi in range(3)]
    host = [branch for est in eng.separate(chunks) for branch in est]
    assert eng.transcribe_branches(refs) == eng.transcribe(host)
