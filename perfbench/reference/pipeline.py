"""The plain reference of one job: what ``Overlap3Pipeline.run()`` gives for a
job's mixtures and enrollment wav, stage by stage, at the batch layout the
engine uses (every mixture padded to its bucket, batches of a power of two up
to 8), from the benchmark's own samples and weights.

The segmentation is forced by the workload (the hysteresis flags make every
mixture one span of its ``kind``), so each mixture gives one record:
overlap spans are separated, each branch scored against the enrollment
embedding, and one branch transcribed; clean spans are scored and
transcribed as they are; every record also carries the transcript of the
enrollment wav over the record's span (the pipeline's target-span ASR).

``follow`` names the branch to transcribe for each overlap record (the
judged side's choice): the reference then says how far below its own best
score that branch lies, instead of transcribing a branch of its own choice.
``given`` holds the judged side's recognizer entries, one a call in the
order of the calls: each is handed to the family's reference call of the
same index, which may read it (teacher forcing).

The recognizer is the configuration's family (``asr/<family>.py``): its
``recognize``, under ``reference/``, is the call.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import models as M

BUCKETS = tuple(int(8000 * 2 ** k) for k in range(7)) + (1024000,)
MAX_BATCH = 8


def bucket_for(n: int) -> int:
    return next(b for b in BUCKETS if n <= b)


def batch_size_for(n: int) -> int:
    b = 1
    while b < n and b < MAX_BATCH:
        b *= 2
    return b


def batch(items: Sequence[np.ndarray], device) -> tuple:
    """int16 items -> ([bs, bucket] float waves in [-1, 1], [bs] lengths)."""
    bucket = max(bucket_for(len(x)) for x in items)
    bs = batch_size_for(len(items))
    wav = np.zeros((bs, bucket), np.float32)
    lengths = np.zeros((bs,), np.int64)
    for i, x in enumerate(items):
        wav[i, :len(x)] = x.astype(np.float32) / 32768.0
        lengths[i] = len(x)
    return torch.from_numpy(wav).to(device), torch.from_numpy(lengths).to(device)


class Reference:
    """The reference models of one configuration on ``device``; ``family``
    is its recognizer family's module."""

    def __init__(self, cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                 pyannote: Dict[str, torch.Tensor], symbols: List[str], device, family,
                 tf32: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.w, self.pn, self.symbols = cfg, weights, pyannote, symbols
        self.device, self.family = device, family
        self.ops = M.Ops(tf32)
        self.sep = "mossformer" if cfg["sep_backend"] == "mossformer" else "sep3"

    # -------------------------------------------------------------- stages
    def embed(self, wav: torch.Tensor, lengths: torch.Tensor):
        feats = M.fbank(self.ops, wav)
        valid = M.fbank_frames(lengths)
        mask = torch.arange(feats.shape[1], device=wav.device)[None, :] < valid[:, None]
        emb = M.speaker(self.ops, self.w["spk"], self.cfg["preset"]["spk"], feats, mask)
        emb = emb / torch.clamp_min(emb.norm(dim=-1, keepdim=True), 1e-12)
        return feats, valid, emb

    def asr(self, wav: torch.Tensor, lengths: torch.Tensor, given: Optional[dict] = None):
        f = self.family
        return f.recognize(self.ops, self.w["asr"], self.cfg["preset"][f.PRESET], self.symbols,
                           wav, lengths, given)

    def separate(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        c = self.cfg["preset"][self.sep]
        fn = M.mossformer if self.sep == "mossformer" else M.convtasnet
        return fn(self.ops, self.w[self.sep], c, wav, lengths)

    # -------------------------------------------------------------- a job
    @torch.no_grad()
    def run_job(self, mixtures: List[np.ndarray], target: np.ndarray, kind: str,
                follow: Optional[Sequence[int]] = None,
                given: Optional[Sequence[dict]] = None) -> dict:
        dev = self.device
        given = iter(given or ())
        n_mix = len(mixtures)
        out: dict = {"feats_spk": [], "emb": [], "asr": []}
        # enrollment: embedding and transcript (a batch of one)
        t_wav, t_len = batch([target], dev)
        feats, valid, t_emb = self.embed(t_wav, t_len)
        out["feats_spk"].append((feats, valid))
        out["emb"].append(t_emb)
        enroll = self.asr(t_wav, t_len, next(given, None))
        out["asr"].append(enroll)
        # OSD over the mixtures
        wav, lengths = batch(mixtures, dev)
        out["osd"] = M.pyannet(self.ops, self.pn, wav, lengths)
        target_vec = t_emb[0]
        records = [{"kind": kind} for _ in range(n_mix)]
        if kind == "overlap":
            est = self.separate(wav, lengths)
            out["sep"] = est
            bs, s, t = est.shape
            feats, valid, emb = self.embed(est.reshape(bs * s, t), lengths.repeat_interleave(s))
            out["feats_spk"].append((feats, valid))
            out["emb"].append(emb)
            scores = (emb.reshape(bs, s, -1) * target_vec).sum(dim=-1)
            own = scores.argmax(dim=-1)
            pick = own if follow is None else torch.as_tensor(
                list(follow) + [0] * (bs - n_mix), device=dev)
            path = self.asr(est[torch.arange(bs, device=dev), pick], lengths, next(given, None))
            for i, r in enumerate(records):
                r["stream"] = int(pick[i])
                r["sv_score"] = float(scores[i, pick[i]])
                r["stream_gap"] = float(scores[i].max() - scores[i, pick[i]])
        else:
            feats, valid, emb = self.embed(wav, lengths)
            out["feats_spk"].append((feats, valid))
            out["emb"].append(emb)
            scores = (emb * target_vec).sum(dim=-1)
            path = self.asr(wav, lengths, next(given, None))
            for i, r in enumerate(records):
                r["stream"] = None
                r["sv_score"] = float(scores[i])
                r["stream_gap"] = 0.0
        out["asr"].append(path)
        # target-span ASR: the enrollment over each record's span
        spans = []
        for x in mixtures:
            e_i = int((len(x) / M.SR) * M.SR)
            spans.append(target[:min(e_i, len(target))])
        tg_wav, tg_len = batch(spans, dev)
        tspan = self.asr(tg_wav, tg_len, next(given, None))
        out["asr"].append(tspan)
        for i, r in enumerate(records):
            r["text"] = path["texts"][i]
            r["text_margin"] = float(path["margin"][i])
            r["target_text"] = tspan["texts"][i] or enroll["texts"][0]
            r["target_margin"] = float(min(tspan["margin"][i], enroll["margin"][0]))
        out["records"] = records
        return out
