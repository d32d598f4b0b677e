"""Real-checkpoint verification harness (``convert_models --verify <dir>``):
port of audio_classification_tpu/models/convert/verify.py.

The importers are tested against SYNTHESIZED graphs and state dicts (the
reference's model files, downloaded by the reference's
scripts/install.sh:52-61, are not in the repository). This module is the
one-command acceptance procedure for users who have those files locally:
point it at the model directory and it

1. discovers every model file by the reference's layout conventions
   (install.sh + the sherpa-onnx flag surface of
   speaker-identification-with-vad-non-streaming-asr.py),
2. per ONNX graph, checks DIRECT-EXECUTION SELF-CONSISTENCY: the graph run
   by the port's executor on the engine's device (convert/onnx_exec) vs
   the same graph on the CPU with every initializer a host constant (the
   weight-only subgraphs folded in numpy): two execution paths over the
   same wire bytes (the JAX harness compares its jitted run with its eager
   one),
3. per mappable stage, checks MAP-vs-DIRECT PARITY: an engine serving the
   graph-aware-imported weights through the port's own modules
   (``--onnx-exec map``) against an engine executing the exported graph
   itself (``--onnx-exec direct``) on the same synthetic audio:
   embeddings numerically, ASR by decoded token ids, VAD by frame
   probabilities,
4. per torch checkpoint (ConvTasNet / MossFormer / pyannote), checks the
   name-mapped import loads into the port's module and its forward is
   finite.

It writes ``verify.json`` with one record per check (status pass / fail /
skipped / error + measured numbers; the keys and check names of the JAX
harness) and returns overall ok = no check failed or errored. ``device``
is the engines' (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

TOL_EXEC = 2e-3      # device vs host-folded CPU run of one graph (f32 ops)
TOL_EMBED = 5e-3     # mapped module vs direct graph, l2-normed embeddings
TOL_VAD = 5e-3


# --------------------------------------------------------------- discovery

@dataclass
class Discovered:
    """One servable model found under the directory."""

    kind: str                      # speaker | sensevoice | paraformer | ...
    files: Dict[str, str]          # role -> path
    extras: Dict[str, str] = field(default_factory=dict)  # tokens/cmvn paths


def discover_models(root: str | Path) -> List[Discovered]:
    """Walk ``root`` for the reference's model files.

    Conventions (install.sh:52-61 + sherpa-onnx release naming):
    speaker ONNX has '3dspeaker'/'eres2net'/'campplus' in the filename; the
    SenseVoice dir is 'sherpa-onnx-sense-voice-*' holding model(.int8).onnx
    + tokens.txt; VAD is 'silero_vad*.onnx'; paraformer/whisper/transducer
    dirs carry their family name with encoder/decoder(/joiner) files;
    torch checkpoints (.bin/.pt/.pth/.ckpt) are matched by name keywords.
    """
    root = Path(root)
    found: List[Discovered] = []
    onnx = sorted(p for p in root.rglob("*.onnx"))
    torch_ckpts = [p for suf in (".bin", ".pt", ".pth", ".ckpt")
                   for p in root.rglob(f"*{suf}")]

    def lower(p: Path) -> str:
        return str(p).lower()

    def tokens_near(p: Path) -> Dict[str, str]:
        ex = {}
        tok = p.parent / "tokens.txt"
        if tok.is_file():
            ex["tokens"] = str(tok)
        mvn = p.parent / "am.mvn"
        if mvn.is_file():
            ex["cmvn"] = str(mvn)
        return ex

    used: set = set()

    def claim(kind, files, extras=None):
        found.append(Discovered(kind, files, extras or {}))
        used.update(files.values())

    for p in onnx:
        lp = lower(p)
        if any(k in lp for k in ("3dspeaker", "eres2net", "campplus",
                                 "speaker-recognition")):
            claim("speaker", {"model": str(p)})
        elif "vad" in Path(lp).name:
            claim("vad", {"model": str(p)})
    for p in onnx:
        lp = lower(p)
        if str(p) in used:
            continue
        name = Path(lp).name
        if "sense" in lp and name.startswith("model"):
            # prefer the int8 export (the reference serves it) but only one
            if name == "model.int8.onnx" or not any(
                    d.kind == "sensevoice" and
                    Path(d.files["model"]).parent == p.parent for d in found):
                for d in [d for d in found if d.kind == "sensevoice"
                          and Path(d.files["model"]).parent == p.parent]:
                    found.remove(d)
                claim("sensevoice", {"model": str(p)}, tokens_near(p))
        elif "paraformer" in lp and "encoder" not in name and "decoder" not in name:
            claim("paraformer", {"model": str(p)}, tokens_near(p))
        elif "whisper" in lp and "encoder" in name:
            dec = next((q for q in onnx if q.parent == p.parent
                        and "decoder" in q.name.lower()), None)
            claim("whisper", {"encoder": str(p)} |
                  ({"decoder": str(dec)} if dec else {}), tokens_near(p))
        elif ("transducer" in lp or "zipformer" in lp) and "encoder" in name:
            dec = next((q for q in onnx if q.parent == p.parent
                        and "decoder" in q.name.lower()), None)
            joi = next((q for q in onnx if q.parent == p.parent
                        and "joiner" in q.name.lower()), None)
            files = {"encoder": str(p)}
            if dec:
                files["decoder"] = str(dec)
            if joi:
                files["joiner"] = str(joi)
            claim("transducer", files, tokens_near(p))
        elif "wenet" in lp and name.startswith("model"):
            claim("wenet_ctc", {"model": str(p)}, tokens_near(p))
        elif "mossformer" in lp:
            claim("mossformer_onnx", {"model": str(p)})
    for p in torch_ckpts:
        lp = lower(p)
        if "tasnet" in lp or ("conv" in lp and "sep" in lp):
            n_src = "3" if ("3" in Path(lp).stem.split("spk")[0][-3:]
                            or "3spk" in lp or "libri3" in lp) else "2"
            claim(f"convtasnet{n_src}", {"checkpoint": str(p)})
        elif "mossformer" in lp:
            claim("mossformer", {"checkpoint": str(p)})
        elif "pyannote" in lp or "segmentation" in lp:
            claim("pyannet", {"checkpoint": str(p)})
    return found


# ------------------------------------------------------ synthetic fixtures

def _synth_feeds(model, rng: np.random.Generator,
                 time_dim: int = 48) -> Dict[str, np.ndarray]:
    """Build plausible feeds from a graph's declared input signature.

    Dynamic dims resolve batch->1, a single large/dynamic middle dim->
    ``time_dim``; int inputs named *len*/*length* get the time size,
    language/textnorm prompts get 0.
    """
    feeds: Dict[str, np.ndarray] = {}
    shapes: Dict[str, List[int]] = {}
    for vi in model.graph.inputs:
        if vi.name in model.graph.initializers:
            continue
        dims: List[int] = []
        for j, d in enumerate(vi.shape):
            if isinstance(d, int) and d > 0:
                dims.append(d)
            elif j == 0:
                dims.append(1)
            elif j == 1 and len(vi.shape) >= 3:
                dims.append(time_dim)
            else:
                dims.append(time_dim if len(vi.shape) == 2 and j == 1 else 16)
        shapes[vi.name] = dims
    for vi in model.graph.inputs:
        if vi.name in model.graph.initializers:
            continue
        dims = shapes[vi.name]
        dt = np.dtype(vi.dtype) if vi.dtype else np.dtype(np.float32)
        lname = vi.name.lower()
        if dt.kind in "iu":
            if "len" in lname:
                # length of the (first) multi-dim float input's time axis
                tlen = next((s[1] for n, s in shapes.items()
                             if len(s) >= 2 and n != vi.name), time_dim)
                feeds[vi.name] = np.full(dims, tlen, dt)
            else:
                feeds[vi.name] = np.zeros(dims, dt)
        elif dt.kind == "b":
            feeds[vi.name] = np.ones(dims, dt)
        else:
            feeds[vi.name] = (rng.standard_normal(dims) * 0.5).astype(dt)
    return feeds


def _tone(n: int, hz: float = 440.0, sr: int = 16000) -> np.ndarray:
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


# ----------------------------------------------------------------- checks

def _check(report: List[Dict], model: str, name: str, fn) -> Optional[Any]:
    t0 = time.time()
    rec = {"model": model, "check": name}
    try:
        out = fn()
        rec.update(out if isinstance(out, dict) else {})
        rec.setdefault("status", "pass")
        result = out
    except _Skip as s:
        rec.update({"status": "skipped", "reason": str(s)})
        result = None
    except Exception as e:  # loud but non-aborting: every model gets a row
        rec.update({"status": "error",
                    "reason": f"{type(e).__name__}: {e}"})
        result = None
    rec["seconds"] = round(time.time() - t0, 2)
    report.append(rec)
    return result


class _Skip(Exception):
    pass


def _exec_consistency(path: str, device=None) -> Dict[str, Any]:
    """The graph on ``device`` vs on the CPU with baked initializers."""
    from .onnx_exec import OnnxModel, supported_ops

    rng = np.random.default_rng(0)
    dm = OnnxModel(path, device=device)
    hm = OnnxModel(path, bake_params=True, device="cpu")
    unsup = sorted({n.op_type for n in dm.graph.nodes}
                   - set(supported_ops()))
    if unsup:
        raise _Skip(f"unsupported ops: {', '.join(unsup)}")
    feeds = _synth_feeds(dm, rng)
    a = {k: v.cpu().numpy() for k, v in dm(**feeds).items()}
    b = {k: v.numpy() for k, v in hm(**feeds).items()}
    max_err = 0.0
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if x.shape != y.shape:
            return {"status": "fail",
                    "reason": f"output {k} shape {x.shape} vs {y.shape}"}
        if x.size:
            max_err = max(max_err, float(np.max(np.abs(x - y))))
    status = "pass" if max_err <= TOL_EXEC else "fail"
    return {"status": status, "max_abs_err": max_err, "tol": TOL_EXEC,
            "outputs": sorted(a)}


def _build_engine_for(d: Discovered, mode: str, preset: str,
                      max_batch: int = 4, device=None):
    from ..pipelines.offline_overlap3 import build_engine
    from ..utils.config import Overlap3Config

    kw: Dict[str, Any] = dict(preset=preset, seed=0, onnx_exec=mode,
                              max_batch=max_batch, max_segment_sec=4.0)
    if d.kind == "speaker":
        kw["spk_embed_model"] = d.files["model"]
    elif d.kind == "sensevoice":
        kw["sense_voice"] = d.files["model"]
    elif d.kind == "paraformer":
        kw["paraformer"] = d.files["model"]
    elif d.kind == "whisper":
        kw["whisper_encoder"] = d.files["encoder"]
        kw["whisper_decoder"] = d.files.get("decoder", "")
    elif d.kind == "transducer":
        kw["encoder"] = d.files["encoder"]
        kw["decoder"] = d.files.get("decoder", "")
        kw["joiner"] = d.files.get("joiner", "")
    else:
        raise _Skip(f"no engine route for kind {d.kind}")
    for role, key in (("tokens", "tokens"), ("cmvn", "cmvn")):
        if role in d.extras:
            kw[key] = d.extras[role]
    return build_engine(Overlap3Config(**kw), device=device)


def _vad_engines(d: Discovered, preset_name: str, device=None):
    """VAD wires through the pack directly (no Overlap3Config field: the
    reference passes --silero-vad-model only to the sp-id script)."""
    from ..engine.runtime import (
        BucketSpec, EnginePreset, ModelPack, StageEngine, tiny_preset,
    )
    from .onnx_graph_map import import_onnx_state_dict
    from .onnx_stage import OnnxStage

    preset = tiny_preset() if preset_name == "tiny" else EnginePreset()
    spec = BucketSpec(lengths=(8000, 16000), max_batch=4)
    pack_map = ModelPack(preset, seed=0, device=device)
    pack_map.load_params(
        "vad", import_onnx_state_dict(d.files["model"], "vad", preset.vad))
    pack_dir = ModelPack(preset, seed=0, device=device)
    pack_dir.set_onnx_stage("vad", OnnxStage(d.files["model"], device=pack_dir.device))
    return StageEngine(pack_map, spec), StageEngine(pack_dir, spec)


def _map_vs_direct(d: Discovered, preset: str, device=None) -> Dict[str, Any]:
    """Graph-aware-mapped module serving vs direct graph execution."""
    try:
        if d.kind == "vad":
            eng_map, eng_dir = _vad_engines(d, preset, device)
        else:
            eng_map = _build_engine_for(d, "map", preset, device=device)
    except _Skip:
        raise
    except Exception as e:
        # mapping topologies drift across exports; the direct executor is
        # the guaranteed route — record why map isn't available
        return {"status": "skipped",
                "reason": f"graph-aware mapping unavailable: "
                          f"{type(e).__name__}: {e}"}
    if d.kind != "vad":
        eng_dir = _build_engine_for(d, "direct", preset, device=device)
    sr = 16000
    chunks = [_tone(sr, 440), _tone(sr // 2, 880)]
    if d.kind == "speaker":
        a = eng_map.embed(chunks)
        b = eng_dir.embed(chunks)
        err = float(np.max(np.abs(a - b)))
        cos = float(np.min(np.sum(a * b, axis=-1)))
        return {"status": "pass" if err <= TOL_EMBED else "fail",
                "max_abs_err": err, "min_cosine": cos, "tol": TOL_EMBED}
    if d.kind == "vad":
        a = eng_map.vad_probs(chunks[0])
        b = eng_dir.vad_probs(chunks[0])
        err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        return {"status": "pass" if err <= TOL_VAD else "fail",
                "max_abs_err": err, "tol": TOL_VAD}
    # ASR families: decoded token ids must agree
    ids_a = eng_map.collect_tokens(eng_map.launch_transcribe(chunks))
    ids_b = eng_dir.collect_tokens(eng_dir.launch_transcribe(chunks))
    mismatch = sum(
        1 for (xa, na), (xb, nb) in zip(ids_a, ids_b)
        if na != nb or list(xa[:na]) != list(xb[:nb]))
    return {"status": "pass" if mismatch == 0 else "fail",
            "chunks": len(chunks), "id_mismatches": mismatch}


def _torch_import_check(d: Discovered, preset_name: str = "full",
                        device=None) -> Dict[str, Any]:
    import torch

    from ..engine.runtime import EnginePreset, resolve_device, tiny_preset

    path = d.files["checkpoint"]
    preset = tiny_preset() if preset_name == "tiny" else EnginePreset()
    dev = resolve_device(device)

    def run(model, sd, *args):
        model.load_state_dict(sd)
        with torch.inference_mode():
            out = model.to(dev).eval()(*(a.to(dev) for a in args))
        finite = bool(torch.isfinite(out).all())
        return {"status": "pass" if finite else "fail", "out_shape": list(out.shape)}

    if d.kind.startswith("convtasnet"):
        from ..models.convtasnet import ConvTasNet
        from .torch_import import load_convtasnet_torch

        cfg = preset.sep3 if d.kind.endswith("3") else preset.sep2
        return run(ConvTasNet(cfg), load_convtasnet_torch(path, cfg),
                   torch.zeros((1, 1600)) + 0.05, torch.ones((1, 1600)))
    if d.kind == "mossformer":
        from ..models.mossformer import MossFormer
        from .torch_import import load_mossformer_torch

        return run(MossFormer(preset.mossformer),
                   load_mossformer_torch(path, preset.mossformer),
                   torch.zeros((1, 1600)) + 0.05, torch.ones((1, 1600)))
    if d.kind == "pyannet":
        from ..models.pyannet import PyanNet
        from .torch_import import load_pyannet_torch

        cfg, sd = load_pyannet_torch(path)
        return run(PyanNet(cfg), sd, torch.zeros((1, 16000)) + 0.01,
                   torch.tensor([16000]))
    raise _Skip(f"no torch route for {d.kind}")


# ------------------------------------------------------------------ driver

def verify_model_dir(root: str | Path, out_json: str | Path = "",
                     preset: str = "full", device=None) -> Dict[str, Any]:
    """Run every applicable check over a local reference model dir, the
    engines on ``device`` (the card by default; "cpu" when asked)."""
    models = discover_models(root)
    report: List[Dict[str, Any]] = []
    for d in models:
        label = f"{d.kind}:{Path(next(iter(d.files.values()))).name}"
        for role, path in d.files.items():
            if path.endswith(".onnx"):
                _check(report, label, f"exec_consistency[{role}]",
                       lambda p=path: _exec_consistency(p, device))
        if d.kind in ("speaker", "sensevoice", "paraformer", "whisper",
                      "transducer", "vad"):
            _check(report, label, "map_vs_direct",
                   lambda dd=d: _map_vs_direct(dd, preset, device))
        if "checkpoint" in d.files:
            _check(report, label, "torch_import",
                   lambda dd=d: _torch_import_check(dd, preset, device))
    ok = all(r["status"] in ("pass", "skipped") for r in report)
    result = {
        "root": str(root),
        "models_found": [
            {"kind": d.kind, "files": d.files, "extras": d.extras}
            for d in models
        ],
        "checks": report,
        "ok": ok,
    }
    if out_json:
        Path(out_json).write_text(json.dumps(result, indent=2))
    return result
