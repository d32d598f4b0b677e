"""The recognizer family ``sensevoice``: the port's SenseVoice-style CTC
encoder (``ModelPack(asr_family="sensevoice")``), whose logits one
``forward`` call a batch gives.

A configuration names its family by ``asr_family`` (``sensevoice`` when the
key is absent); ``harness.load_family`` loads ``asr/<family>.py`` by that
name. A family module holds everything of its recognizer that the shared
code dispatches to:

    PACK_FAMILY     the port's ``ModelPack`` family
    PRESET          the ``EnginePreset`` field, and the configuration's
                    ``preset`` key, that holds the recognizer's widths
    PUBLISHED       the published model's widths: every configuration of
                    the family holds them under ``preset[PRESET]``
    token_symbols   the benchmark's token table at those widths
    token_table     the port's ``TokenTable`` of those symbols
    spec            the state dict's names, shapes and leaf kinds
                    (``weights.fill``; the stage's tag stays ``asr``'s)
    flops           the model FLOPs of one call on n samples, frontend
                    included (``work.job_flops``)
    capture         installs on ``pack.models["asr"]`` what keeps each call
                    (handed to ``keep``); returns handles with ``remove()``
    program_entry   one kept call -> the ``asr`` entry ``check`` reads:
                    ``feats``, ``mask``, ``logits``
    recognize       the reference's call, under ``reference/``; it may read
                    the program's entry of the same call (teacher forcing)
"""
from __future__ import annotations

from typing import Callable, List

from perfbench import work
from perfbench.reference.sensevoice import recognize  # noqa: F401 (the family's reference)
from perfbench.weights import Spec, _conv1d, _lin, _norm

PACK_FAMILY = "sensevoice"
PRESET = "asr"
PUBLISHED = {"dim": 512, "heads": 4, "layers": 70, "vocab_size": 25055}  # SenseVoiceSmall


def token_symbols(c: dict) -> List[str]:
    """The benchmark's token table: ``<blk>`` at 0, then for id i its letters
    in base 26, every third id a word start (``▁``)."""
    out = ["<blk>"]
    for i in range(1, c["vocab_size"]):
        s, k = "", i
        while k:
            k, r = divmod(k - 1, 26)
            s = chr(97 + r) + s
        out.append(("▁" + s) if i % 3 == 0 else s)
    return out


def token_table(symbols: List[str]):
    from audio_classification_tpu_torch.models.asr.tokens import TokenTable

    return TokenTable(dict(enumerate(symbols)), blank_id=0)


def spec(c: dict) -> Spec:
    d, v = c["dim"], c["vocab_size"]
    out = [*_lin("in_proj", d, c["lfr_m"] * c["num_mel"]), ("lang_embed", (7, d), "b"),
           ("itn_embed", (2, d), "b"), ("prompt_pad", (c["num_prompt"] - 2, d), "b")]
    for i in range(c["layers"]):
        p = f"block_{i}"
        out += [*_norm(f"{p}.LayerNorm_0", d, "weight", "bias"),
                *_lin(f"{p}.MultiHeadSelfAttention_0.qkv", 3 * d, d),
                *_lin(f"{p}.MultiHeadSelfAttention_0.out", d, d),
                *_norm(f"{p}.LayerNorm_1", d, "weight", "bias"),
                *_conv1d(f"{p}.dwconv", d, 1, c["conv_kernel"]),
                *_norm(f"{p}.LayerNorm_2", d, "weight", "bias"),
                *_lin(f"{p}.Dense_0", d * c["ffn_mult"], d),
                *_lin(f"{p}.Dense_1", d, d * c["ffn_mult"])]
    out += [*_norm("final_ln", d, "weight", "bias"), *_lin("ctc_head", v, d)]
    return out


def sensevoice_flops(n: int, c: dict) -> float:
    """The SenseVoice encoder on the LFR frames of n samples (and its four
    prompt frames): input projection, every block's projections, attention,
    depthwise conv and feed-forward, and the CTC head."""
    t = -(-max(work.fbank_frames(n), 0) // c["lfr_n"]) + c["num_prompt"]
    d = c["dim"]
    block = t * (2.0 * 3 * d * d + 2.0 * d * d + 2.0 * d * c["conv_kernel"]
                 + 2 * 2.0 * d * d * c["ffn_mult"]) + 4.0 * t * t * d
    return (t * 2.0 * c["lfr_m"] * c["num_mel"] * d + c["layers"] * block
            + t * 2.0 * d * c["vocab_size"])


def flops(n: int, c: dict) -> float:
    """One call on n samples: the kaldi log-mel frontend (K1) and the encoder."""
    return work.fbank_flops(n) + sensevoice_flops(n, c)


def capture(model, keep: Callable) -> list:
    """A forward hook on the encoder: each call's positional inputs and its
    logits, as they are (device tensors; no copy, no wait)."""
    return [model.register_forward_hook(lambda _module, args, out: keep((args, out)))]


def program_entry(kept: tuple) -> dict:
    args, logits = kept
    return {"feats": args[0], "mask": args[1], "logits": logits}
