"""Shared set-up of the port's ONNX tests (not a test module).

* Fixture graphs shaped like the reference's exports, as
  tests/test_onnx_stage.py builds them (helpers_onnx writes the bytes): a
  speaker graph (fbank feats -> embedding), a SenseVoice-style CTC graph
  with x_length / language / textnorm inputs, a Paraformer graph with the
  (logits, token_num) pair, the transducer triple, the whisper pair with
  its self-attention cache IO, and a WeNet CTC graph.
* ``jax_twin``: a JAX ModelPack holding the port pack's weights, built
  without running the JAX initializers (``shape_only_init``: flax's
  ``Module.init`` traced for shapes only, ~1 s instead of a minute of eager
  init on the CPU); every weight is then the port's
  (convert/from_jax.module_variables).
"""
import contextlib

import jax
import numpy as np
from flax import linen as nn

from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu_torch.convert.from_jax import module_variables
from helpers_onnx import GraphBuilder, model_bytes, node, value_info


@contextlib.contextmanager
def shape_only_init():
    orig = nn.Module.init

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r: orig(self, r, *args, **kw), rngs)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = orig


def twin_pack_factory(pack):
    """A stand-in for the JAX ``ModelPack`` class that JAX tools build
    their pack with: shape-only init, then the port ``pack``'s weights
    (the ASR stage's only for the SenseVoice family)."""
    def make(preset, *a, **k):
        with shape_only_init():
            jp = JaxModelPack(preset, *a, **k)
        for stage, tree in module_variables(pack.models).items():
            if stage != "asr" or k.get("asr_family", "sensevoice") == "sensevoice":
                jp.params[stage] = tree
        return jp
    return make


def reference_model_dir(root, pack, chars):
    """A reference-layout model tree (install.sh names) of ``pack``'s
    weights: the speaker and VAD exports, a sherpa-style SenseVoice dir
    (``sensevoice_mappable_graph`` as model.onnx + a tokens.txt of
    ``chars``) and an asteroid Conv-TasNet checkpoint -> ``root``."""
    from audio_classification_tpu_torch.convert import onnx_export
    from audio_classification_tpu_torch.convert.from_jax import state_dict_to_variables
    from torch_port_helpers import asteroid_convtasnet_state_dict, save_torch_checkpoint

    var = {k: state_dict_to_variables(m) for k, m in pack.models.items()}
    spk = root / "models" / "speaker-recognition"
    spk.mkdir(parents=True)
    onnx_export.export_speaker(var["spk"], pack.preset.spk,
                               str(spk / "3dspeaker_speech_eres2net_tiny_sv_16k.onnx"), frames=98)
    vad = root / "models" / "vad"
    vad.mkdir(parents=True)
    onnx_export.export_vadnet(var["vad"], pack.preset.vad, str(vad / "silero_vad.onnx"),
                              frames=98)
    sv = root / "models" / "asr" / "sherpa-onnx-sense-voice-tiny"
    sv.mkdir(parents=True)
    sensevoice_mappable_graph(var["asr"], pack.asr_cfg, sv / "model.onnx", frames=200)
    (sv / "tokens.txt").write_text("\n".join(["<blk> 0"] + [f"{c} {i}" for i, c in
                                                            enumerate(chars, 1)]) + "\n",
                                   encoding="utf-8")
    sep = root / "models" / "separation"
    sep.mkdir(parents=True)
    save_torch_checkpoint(sep / "convtasnet_libri3mix_3spk.pth",
                          asteroid_convtasnet_state_dict(pack.preset.sep3,
                                                         np.random.RandomState(0)))
    return root


def jax_twin(pack, jax_preset, **kw) -> JaxModelPack:
    """A JAX ModelPack of ``jax_preset`` (its ASR family, tokens, ... from
    ``kw``) holding the weights of the port's ``pack``."""
    with shape_only_init():
        jpack = JaxModelPack(jax_preset, seed=0, **kw)
    for stage, tree in module_variables(pack.models).items():
        jpack.params[stage] = tree
    return jpack


def speaker_graph(path, rng, mel=80, dim=32):
    """fbank feats [B,T,mel] -> mean over time -> Gemm -> embedding [B,dim]."""
    g = GraphBuilder()
    g.op("ReduceMean", axes=[1], keepdims=0)
    g.gemm(rng.randn(dim, mel).astype(np.float32), rng.randn(dim).astype(np.float32))
    return g.write(path, inputs=[("input", np.float32, ["B", "T", mel])],
                   outputs=[(g.value, np.float32, ["B", dim])])


def asr_graph(path, rng, lfr_dim, vocab):
    """LFR feats x [B,T,D] (+ x_length / language / textnorm, as the real
    SenseVoice export takes them, src/model.py:79-87) -> MatMul+Add ->
    logits."""
    g = GraphBuilder()
    wn = g.add_init("w", rng.randn(lfr_dim, vocab).astype(np.float32) * 0.5)
    bn = g.add_init("b", rng.randn(vocab).astype(np.float32))
    g.raw("MatMul", ["x", wn], ["mm"])
    g.raw("Add", ["mm", bn], ["logits"])
    return g.write(path, inputs=[("x", np.float32, ["B", "T", lfr_dim]),
                                 ("x_length", np.int32, ["B"]),
                                 ("language", np.int32, ["B"]),
                                 ("textnorm", np.int32, ["B"])],
                   outputs=[("logits", np.float32, ["B", "T", vocab])])


def paraformer_graph(path, rng, lfr_dim, vocab, n_head=5, fire=4):
    """speech [B,T,D] + speech_lengths [B] -> (logits [B,n_head,V],
    token_num [B]), as the funasr / sherpa Paraformer export."""
    g = GraphBuilder()
    wn = g.add_init("w", (rng.randn(lfr_dim, vocab) * 0.5).astype(np.float32))
    bn = g.add_init("b", rng.randn(vocab).astype(np.float32))
    s0 = g.add_init("starts", np.array([0], np.int64))
    e0 = g.add_init("ends", np.array([n_head], np.int64))
    a0 = g.add_init("axes", np.array([1], np.int64))
    g.raw("Slice", ["speech", s0, e0, a0], ["head"])
    g.raw("MatMul", ["head", wn], ["mm"])
    g.raw("Add", ["mm", bn], ["logits"])
    cap = g.add_init("cap", np.array([fire], np.int32))
    g.raw("Min", ["speech_lengths", cap], ["token_num"])
    return g.write(path, inputs=[("speech", np.float32, ["B", "T", lfr_dim]),
                                 ("speech_lengths", np.int32, ["B"])],
                   outputs=[("logits", np.float32, ["B", n_head, vocab]),
                            ("token_num", np.int32, ["B"])])


def transducer_triple(tmp_path, rng, mel=80, d=16, emb_dim=8, V=64):
    """encoder / decoder / joiner graphs shaped like the sherpa export
    (reference: src/model.py:88-99) -> their three paths."""
    enc = model_bytes(
        [node("MatMul", ["x", "we"], ["encoder_out"]),
         node("Identity", ["x_lens"], ["encoder_out_lens"])],
        {"we": (rng.randn(mel, d) * 0.5).astype(np.float32)},
        inputs=[value_info("x", np.float32, ["B", "T", mel]),
                value_info("x_lens", np.int32, ["B"])],
        outputs=[value_info("encoder_out", np.float32, ["B", "T", d]),
                 value_info("encoder_out_lens", np.int32, ["B"])])
    dec = model_bytes(
        [node("Gather", ["emb", "y"], ["ge"]),
         node("Reshape", ["ge", "flat_shape"], ["flat"]),
         node("Gemm", ["flat", "wd", "bd"], ["decoder_out"], transB=1)],
        {"emb": (rng.randn(V, emb_dim) * 0.5).astype(np.float32),
         "flat_shape": np.array([0, 2 * emb_dim], np.int64),
         "wd": (rng.randn(d, 2 * emb_dim) * 0.5).astype(np.float32),
         "bd": rng.randn(d).astype(np.float32)},
        inputs=[value_info("y", np.int64, ["B", 2])],
        outputs=[value_info("decoder_out", np.float32, ["B", d])])
    join = model_bytes(
        [node("Add", ["encoder_out", "decoder_out"], ["s"]),
         node("Tanh", ["s"], ["h"]),
         node("Gemm", ["h", "wj", "bj"], ["logit"], transB=1)],
        {"wj": (rng.randn(V, d) * 0.5).astype(np.float32),
         "bj": rng.randn(V).astype(np.float32)},
        inputs=[value_info("encoder_out", np.float32, ["B", d]),
                value_info("decoder_out", np.float32, ["B", d])],
        outputs=[value_info("logit", np.float32, ["B", V])])
    paths = []
    for name, blob in (("enc", enc), ("dec", dec), ("join", join)):
        (tmp_path / f"{name}.onnx").write_bytes(blob)
        paths.append(str(tmp_path / f"{name}.onnx"))
    return tuple(paths)


def whisper_pair(tmp_path, rng, mel=80, d=8, V=64, metadata=None):
    """encoder / decoder like the sherpa whisper export (reference: sp-id
    script:316-345): channels-first mel encoder -> cross tensor; a decoder
    with tokens / offset / self-cache IO whose greedy chain is
    sot(3) -> 4 -> 5 -> 6 -> eot(2)."""
    enc = model_bytes(
        [node("Transpose", ["mel_in"], ["tm"], perm=[0, 2, 1]),
         node("MatMul", ["tm", "we"], ["proj"]),
         node("ReduceMean", ["proj"], ["cross"], axes=[1], keepdims=1)],
        {"we": (rng.randn(mel, d) * 0.5).astype(np.float32)},
        inputs=[value_info("mel_in", np.float32, ["B", mel, "T"])],
        outputs=[value_info("cross", np.float32, ["B", 1, d])],
        metadata=metadata)
    tmat = np.zeros((V, V), np.float32)
    for a, b_ in ((3, 4), (4, 5), (5, 6), (6, 2)):
        tmat[a, b_] = 5.0
    dec = model_bytes(
        [node("Gather", ["tmat", "tokens"], ["tl"]),
         node("MatMul", ["cross", "wc"], ["cl"]),
         node("Mul", ["cl", "small"], ["cls"]),
         node("Add", ["tl", "cls"], ["logits"]),
         node("Add", ["in_self_cache", "one"], ["out_self_cache"])],
        {"tmat": tmat, "wc": (rng.randn(d, V) * 0.1).astype(np.float32),
         "small": np.asarray(0.01, np.float32), "one": np.asarray(1.0, np.float32)},
        inputs=[value_info("tokens", np.int64, ["B", "n"]),
                value_info("offset", np.int64, ["B"]),
                value_info("in_self_cache", np.float32, [2, "B", 4, d]),
                value_info("cross", np.float32, ["B", 1, d])],
        outputs=[value_info("logits", np.float32, ["B", "n", V]),
                 value_info("out_self_cache", np.float32, [2, "B", 4, d])])
    (tmp_path / "wenc.onnx").write_bytes(enc)
    (tmp_path / "wdec.onnx").write_bytes(dec)
    return str(tmp_path / "wenc.onnx"), str(tmp_path / "wdec.onnx")


def wenet_graph(path, rng, mel, vocab):
    """WeNet-style CTC: plain fbank frames + lengths -> logits, no prompts."""
    blob = model_bytes(
        [node("MatMul", ["speech", "w"], ["logits"])],
        {"w": (rng.randn(mel, vocab) * 0.5).astype(np.float32)},
        inputs=[value_info("speech", np.float32, ["B", "T", mel]),
                value_info("speech_lengths", np.int32, ["B"])],
        outputs=[value_info("logits", np.float32, ["B", "T", vocab])])
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


def _einsum_block(ox, g, x, blk, dim, heads, conv_kernel):
    """onnx_export._transformer_block with the attention products as Einsum
    nodes: the graph-aware importer takes every MatMul / Gemm for a dense
    layer, so a graph with MatMul attention does not map."""
    dh = dim // heads
    h = ox._layernorm(g, x, blk["LayerNorm_0"])
    q, k, v = g.add("Split", [ox._dense(g, h, blk["MultiHeadSelfAttention_0"]["qkv"])],
                    n_out=3, axis=-1)

    def split_heads(z):
        z = g.add("Reshape", [z, g.init("shape", np.asarray([0, 0, heads, dh], np.int64))])
        return g.add("Transpose", [z], perm=[0, 2, 1, 3])

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    s = g.add("Einsum", [q, k], equation="bhqd,bhkd->bhqk")
    s = g.add("Mul", [s, g.init("scale", np.float32(1.0 / np.sqrt(dh)).reshape(()))])
    o = g.add("Einsum", [g.add("Softmax", [s], axis=-1), v], equation="bhqk,bhkd->bhqd")
    o = g.add("Transpose", [o], perm=[0, 2, 1, 3])
    o = g.add("Reshape", [o, g.init("shape", np.asarray([0, 0, dim], np.int64))])
    x = g.add("Add", [x, ox._dense(g, o, blk["MultiHeadSelfAttention_0"]["out"])])
    if conv_kernel > 0:
        hc = g.add("Transpose", [ox._layernorm(g, x, blk["LayerNorm_1"])], perm=[0, 2, 1])
        hc = ox._conv(g, hc, blk["dwconv"], groups=dim, pads=ox._same_pads(1, conv_kernel))
        x = g.add("Add", [x, ox._silu(g, g.add("Transpose", [hc], perm=[0, 2, 1]))])
    h = ox._layernorm(g, x, blk["LayerNorm_2" if conv_kernel > 0 else "LayerNorm_1"])
    h = ox._gelu_tanh(g, ox._dense(g, h, blk["Dense_0"]))
    return g.add("Add", [x, ox._dense(g, h, blk["Dense_1"])])


def sensevoice_mappable_graph(tree, cfg, path, frames: int) -> str:
    """The SenseVoice encoder as ``onnx_export.export_sensevoice`` writes
    it, but with the text-norm row gathered from a runtime ``textnorm``
    input, as the reference's sherpa export takes it, instead of a baked
    row, and with Einsum attention (``_einsum_block``): the exporter's own
    graph does not map back (ROADMAP §3). The positional table is sliced to
    the input's frame count (a Shape chain the executors fold), so the
    graph runs directly on any count up to ``frames`` (feats [batch, T] +
    language [1] + textnorm [1] -> logits)."""
    from audio_classification_tpu_torch.convert import onnx_export as ox
    from audio_classification_tpu_torch.models.common import sinusoidal_positions

    p = tree["params"]
    pr = cfg.num_prompt
    i64 = lambda v: np.asarray(v, np.int64)
    g = ox.OnnxGraphWriter("sensevoice")
    x = ox._dense(g, "feats", p["in_proj"])
    lang = g.add("Gather", [g.init("lang_embed", np.asarray(p["lang_embed"], np.float32)),
                            "language"], axis=0)
    itn = g.add("Gather", [g.init("itn_embed", np.asarray(p["itn_embed"], np.float32)),
                           "textnorm"], axis=0)
    prompt = g.add("Concat", [lang, itn, g.init("prompt_pad", np.asarray(p["prompt_pad"],
                                                                         np.float32))], axis=0)
    prompt = g.add("Unsqueeze", [prompt, g.init("axes", i64([0]))])
    shp = g.add("Shape", ["feats"])
    batch = g.add("Slice", [shp, g.init("s", i64([0])), g.init("e", i64([1]))])
    target = g.add("Concat", [batch, g.init("pd", i64([pr, cfg.dim]))], axis=0)
    x = g.add("Concat", [g.add("Expand", [prompt, target]), x], axis=1)
    t = g.add("Add", [g.add("Slice", [shp, g.init("s", i64([1])), g.init("e", i64([2]))]),
                      g.init("pr", i64([pr]))])
    pos = g.add("Slice", [g.init("pos", sinusoidal_positions(frames + pr, cfg.dim)),
                          g.init("s", i64([0])), t, g.init("a", i64([0]))])
    x = g.add("Add", [x, pos])
    for i in range(cfg.layers):
        x = _einsum_block(ox, g, x, p[f"block_{i}"], cfg.dim, cfg.heads, cfg.conv_kernel)
    x = ox._layernorm(g, x, p["final_ln"])
    g.add("Identity", [ox._dense(g, x, p["ctc_head"])], out="logits")
    blob = g.serialize(
        inputs=[("feats", np.float32, ["batch", "frames", cfg.lfr_m * cfg.num_mel]),
                ("language", np.int64, [1]), ("textnorm", np.int64, [1])],
        outputs=[("logits", np.float32, ["batch", "prompt_frames", cfg.vocab_size])])
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)
