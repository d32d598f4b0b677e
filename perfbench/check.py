"""The comparison that decides ``correct``: a judged side's outputs of a job
against the plain reference's, number by number, each number against the
limit the cell's file under ``perfbench/limits/`` gives it.

Both sides are dicts of one shape (``reference.pipeline.Reference.run_job``
builds the reference's; ``harness`` builds the program's from what its hooks
captured and from the records ``run()`` returned): ``osd`` [B, T', classes]
PyanNet activations; ``sep`` [B, S, T] separated branches (overlap cells);
``feats_spk`` / ``emb`` a list per embedder call (the enrollment, then the
branches or the clean spans) of (log-mel, valid frames) and unit-norm
embeddings; ``asr`` a list per recognizer call (the enrollment, the records'
spans, the enrollment over the records' spans) of its features, frame mask,
logits and the positions that count; ``records`` one per mixture.

Numbers, each the largest over the jobs compared:

    osd         max |activation difference|
    fbank       max over valid frames of max |mel power difference| / the
                frame's largest mel power (from the log-mel), every call
    sep         max over branches of max |difference| / max |reference|
    emb         max |difference| of the unit-norm embeddings
    logits      max over calls of max |difference| / max |reference logit|
    sv_score    records whose sv_score differs from the reference's score of
                that branch by more than the records' rounding to 4 decimals
                and what the embeddings' differences allow (|d(e . t)| <=
                |de| + |dt| for unit vectors) (exact: limit 0)
    stream      records whose branch is not the reference's best, where the
                best scores more than twice the sv_score difference (and the
                records' 1e-4 rounding) above it (exact: limit 0)
    text        records whose text (or target text) differs from the
                reference's, where no frame's top-2 logit margin is within
                twice the call's largest logit difference (exact: limit 0)
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import torch

SV_ROUNDING = 0.5e-4  # the records' sv_score is rounded to 4 decimals
NAMES = ("osd", "fbank", "sep", "emb", "logits", "sv_score", "stream", "text")


def load_limits(cell: str, root: Path) -> Dict[str, float]:
    with open(root / "limits" / f"{cell}.json", encoding="utf-8") as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["limits"].items()}


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return math.inf
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _rows_valid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device)[None, :] < valid.to(x.device)[:, None]


def _power_err(f_s: torch.Tensor, f_r: torch.Tensor, valid: torch.Tensor) -> float:
    """Max over valid frames of the largest mel-power difference over the
    frame's largest mel power (log-mel in, frames stacked or not: stacked
    frames are compared as a whole)."""
    if f_s.shape != f_r.shape:
        return math.inf
    p_s, p_r = torch.exp(f_s.double()), torch.exp(f_r.double())
    peak = p_r.amax(dim=-1).clamp_min(1e-30)
    err = (p_s - p_r).abs().amax(dim=-1) / peak
    return float((err * valid).max()) if err.numel() else 0.0


def compare_job(side: dict, ref: dict, n_mix: int) -> Dict[str, float]:
    """The numbers of one job (``n_mix`` mixtures: rows past it are the
    engine's padding of a batch and are not judged)."""
    out = {k: 0.0 for k in NAMES}
    out["osd"] = _max_abs(side["osd"][:n_mix], ref["osd"][:n_mix])
    pairs = [(f_s, f_r, _rows_valid(f_r, v_r))
             for (f_s, _), (f_r, v_r) in zip(side["feats_spk"], ref["feats_spk"])]
    pairs += [(a_s["feats"], a_r["feats"], a_r["mask"])
              for a_s, a_r in zip(side["asr"], ref["asr"])]
    out["fbank"] = max(_power_err(f_s, f_r, m) for f_s, f_r, m in pairs)
    if ref.get("sep") is not None:
        s, r = side["sep"][:n_mix].float(), ref["sep"][:n_mix]
        if s.shape != r.shape:
            out["sep"] = math.inf
        else:
            peak = r.abs().amax(dim=(1, 2)).clamp_min(1e-12)
            out["sep"] = float(((s - r).abs().amax(dim=(1, 2)) / peak).max())
    em, l2 = 0.0, []
    for k, (e_s, e_r) in enumerate(zip(side["emb"], ref["emb"])):
        rows = 1 if k == 0 else n_mix * (e_r.shape[0] // max(ref["osd"].shape[0], 1))
        em = max(em, _max_abs(e_s[:rows], e_r[:rows]))
        l2.append(float((e_s[:rows].float() - e_r[:rows]).norm(dim=-1).max())
                  if e_s.shape == e_r.shape else math.inf)
    out["emb"] = em
    sv_tol = SV_ROUNDING + 1.01 * sum(l2) + 1e-7
    logit_gap = []
    lg = 0.0
    for k, (a_s, a_r) in enumerate(zip(side["asr"], ref["asr"])):
        rows = 1 if k == 0 else n_mix
        ls, lr, pos = a_s["logits"][:rows], a_r["logits"][:rows], a_r["pos"][:rows]
        if ls.shape != lr.shape:
            logit_gap.append(math.inf)
            lg = math.inf
            continue
        d = float(((ls.float() - lr).abs() * pos[..., None]).max())
        logit_gap.append(d)
        lg = max(lg, d / max(float((lr.abs() * pos[..., None]).max()), 1e-12))
    out["logits"] = lg
    recs_s, recs_r = side["records"], ref["records"]
    text = stream = sv = 0
    for rs, rr in zip(recs_s, recs_r):
        d_sv = abs(float(rs["sv_score"]) - rr["sv_score"])
        sv += d_sv > sv_tol
        if rr["stream_gap"] > 2 * d_sv + 1e-4:
            stream += 1
        if rr["text_margin"] > 2 * logit_gap[1] and rs["text"] != rr["text"]:
            text += 1
        tg = max(logit_gap[0], logit_gap[2])
        if rr["target_margin"] > 2 * tg and rs["target_text"] != rr["target_text"]:
            text += 1
    out["text"] = float(text)
    out["stream"] = float(stream)
    out["sv_score"] = float(sv)
    return out


def worst(per_job: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(j[k] for j in per_job) for k in NAMES} if per_job else {}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (an exact number's limit is 0)."""
    return bool(numbers) and all(numbers[k] <= limits[k] for k in limits)
