"""Graph-aware ONNX -> parameter-tree mapping: the port's own copy of
audio_classification_tpu/models/convert/onnx_graph_map.py.

The reference runs its speaker embedder / SenseVoice ASR / silero VAD as
ONNX graphs under onnxruntime (reference: src/model.py:79-124,
install.sh:52-61, speaker-identification-...py:510-520). This module turns
a parsed ONNX graph (onnx_import.load_onnx_graph) into the matching
module's parameter tree, in the flax layout the JAX package's modules take;
``convert/from_jax.params_to_state_dicts`` then maps the tree onto the
port's modules (``import_onnx_state_dict`` does both), so the mapping
stays a line-for-line copy of the JAX one:

- weights are assigned by STRUCTURAL POSITION: ops of each kind (Conv,
  Gemm/MatMul, BatchNormalization, LayerNormalization, Gather) are consumed
  in graph/topological order, which for these feed-forward nets is the
  execution order; robust to stripped/renamed tensor names;
- every assignment validates the tensor shape against the module config, so
  a topology mismatch fails loudly instead of loading garbage;
- int8-quantized graphs resolve through DequantizeLinear (per-tensor or
  per-axis scale/zero-point), plus Identity/Transpose/Reshape chains.

Layout conversions:
  ONNX Conv2d W [O, I/g, kh, kw] -> flax nn.Conv kernel [kh, kw, I/g, O]
  ONNX Conv1d W [O, I/g, k]      -> Conv1d kernel [k, I/g, O]
  ONNX Gemm  W [out, in] (transB=1) or [in, out] -> Dense kernel [in, out]
  BatchNormalization (scale, B, mean, var) -> params{scale,bias} +
      batch_stats{mean,var}
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .onnx_import import OnnxGraph, OnnxNode


class GraphMapper:
    """Tensor resolution + ordered op queues over one ONNX graph."""

    def __init__(self, graph: OnnxGraph):
        self.g = graph
        self.producer: Dict[str, OnnxNode] = {
            o: n for n in graph.nodes for o in n.outputs
        }
        self.consumers: Dict[str, List[OnnxNode]] = {}
        for n in graph.nodes:
            for i in n.inputs:
                self.consumers.setdefault(i, []).append(n)

    # ------------------------------------------------------------ tensors
    def tensor(self, name: str) -> Optional[np.ndarray]:
        """Resolve a value name to a constant array, following
        Identity/DequantizeLinear/Transpose/Reshape producers."""
        if name in self.g.initializers:
            return self.g.initializers[name]
        node = self.producer.get(name)
        if node is None:
            return None
        if node.op_type == "Identity":
            return self.tensor(node.inputs[0])
        if node.op_type == "Constant":
            v = node.attrs.get("value")
            return np.asarray(v) if v is not None else None
        if node.op_type == "DequantizeLinear":
            w = self.tensor(node.inputs[0])
            scale = self.tensor(node.inputs[1])
            zp = self.tensor(node.inputs[2]) if len(node.inputs) > 2 else None
            if w is None or scale is None:
                return None
            wf = w.astype(np.float32)
            zf = zp.astype(np.float32) if zp is not None else np.float32(0.0)
            sf = scale.astype(np.float32)
            if sf.ndim >= 1 and sf.size > 1:  # per-axis
                axis = int(node.attrs.get("axis", 1))
                shape = [1] * wf.ndim
                shape[axis] = sf.size
                sf = sf.reshape(shape)
                zf = zf.reshape(shape) if np.ndim(zf) >= 1 and zf.size > 1 else zf
            return (wf - zf) * sf
        if node.op_type == "Transpose":
            x = self.tensor(node.inputs[0])
            perm = node.attrs.get("perm")
            return None if x is None else np.transpose(x, perm)
        if node.op_type == "Reshape":
            x = self.tensor(node.inputs[0])
            shp = self.tensor(node.inputs[1])
            return None if x is None or shp is None else x.reshape(shp.astype(int))
        return None

    def need(self, name: str, what: str) -> np.ndarray:
        t = self.tensor(name)
        if t is None:
            raise ValueError(f"cannot resolve {what} tensor '{name}' to a constant")
        return t

    # ------------------------------------------------------------ weights
    def conv2d(self, node: OnnxNode, out_ch: int) -> Dict[str, np.ndarray]:
        w = self.need(node.inputs[1], "Conv weight")
        if w.ndim != 4 or w.shape[0] != out_ch:
            raise ValueError(f"Conv '{node.name}': weight {w.shape}, expected out={out_ch}, 4-D")
        b = (self.need(node.inputs[2], "Conv bias") if len(node.inputs) > 2
             else np.zeros(out_ch, np.float32))
        return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0), np.float32),
                "bias": b.astype(np.float32)}

    def conv1d(self, node: OnnxNode, out_ch: int) -> Dict[str, np.ndarray]:
        w = self.need(node.inputs[1], "Conv weight")
        if w.ndim != 3 or w.shape[0] != out_ch:
            raise ValueError(f"Conv '{node.name}': weight {w.shape}, expected out={out_ch}, 3-D")
        b = (self.need(node.inputs[2], "Conv bias") if len(node.inputs) > 2
             else np.zeros(out_ch, np.float32))
        return {"kernel": np.ascontiguousarray(w.transpose(2, 1, 0), np.float32),
                "bias": b.astype(np.float32)}

    def dense(self, node: OnnxNode, out_dim: int) -> Dict[str, np.ndarray]:
        w = self.need(node.inputs[1], "Gemm/MatMul weight")
        if node.op_type == "Gemm" and int(node.attrs.get("transB", 0)):
            w = w.T
        if w.ndim != 2 or w.shape[1] != out_dim:
            raise ValueError(f"{node.op_type} '{node.name}': weight {w.shape} "
                             f"(after transB), expected [*, {out_dim}]")
        b = None
        if node.op_type == "Gemm" and len(node.inputs) > 2:
            b = self.need(node.inputs[2], "Gemm bias")
        elif node.op_type == "MatMul":
            # torch MatMul+Add export: bias lives on the consumer Add
            for c in self.consumers.get(node.outputs[0], []):
                if c.op_type == "Add":
                    other = [i for i in c.inputs if i != node.outputs[0]]
                    if other:
                        t = self.tensor(other[0])
                        if t is not None and t.ndim == 1:
                            b = t
                            break
        if b is None:
            b = np.zeros(out_dim, np.float32)
        return {"kernel": np.ascontiguousarray(w, np.float32), "bias": b.astype(np.float32)}

    def batchnorm(self, node: OnnxNode, ch: int):
        s, b, mean, var = (self.need(i, "BatchNormalization input") for i in node.inputs[1:5])
        for t in (s, b, mean, var):
            if t.shape != (ch,):
                raise ValueError(f"BatchNormalization '{node.name}': {t.shape} != ({ch},)")
        return ({"scale": s.astype(np.float32), "bias": b.astype(np.float32)},
                {"mean": mean.astype(np.float32), "var": var.astype(np.float32)})

    def layernorm(self, node: OnnxNode, ch: int) -> Dict[str, np.ndarray]:
        s = self.need(node.inputs[1], "LayerNormalization scale")
        b = (self.need(node.inputs[2], "LayerNormalization bias")
             if len(node.inputs) > 2 else np.zeros(ch, np.float32))
        if s.shape != (ch,):
            raise ValueError(f"LayerNormalization '{node.name}': {s.shape} != ({ch},)")
        return {"scale": s.astype(np.float32), "bias": b.astype(np.float32)}


class _QueueSet:
    """Ordered weight-bearing op queues + typed pop helpers for one graph."""

    def __init__(self, graph: OnnxGraph, who: str):
        self.m = GraphMapper(graph)
        self.who = who
        self.denses = deque(graph.ops("Gemm", "MatMul"))
        self.lns = deque(graph.ops("LayerNormalization"))
        self.convs = deque(graph.ops("Conv"))

    def _pop(self, q, kind):
        if not q:
            raise ValueError(f"{self.who}: ran out of {kind} nodes")
        return q.popleft()

    def dense(self, out_dim: int) -> Dict[str, np.ndarray]:
        return self.m.dense(self._pop(self.denses, "Gemm/MatMul"), out_dim)

    def ln(self, dim: int) -> Dict[str, np.ndarray]:
        return self.m.layernorm(self._pop(self.lns, "LayerNormalization"), dim)

    def conv1d(self, out_ch: int) -> Dict[str, np.ndarray]:
        return self.m.conv1d(self._pop(self.convs, "Conv"), out_ch)

    def transformer_block(self, dim: int, ffn_mult: int, conv_kernel: int) -> Dict[str, object]:
        """models/common.TransformerBlock in execution order: ln -> qkv ->
        out [-> ln -> dwconv] -> ln -> ffn_up -> ffn_down."""
        blk: Dict[str, object] = {"LayerNorm_0": self.ln(dim)}
        blk["MultiHeadSelfAttention_0"] = {"qkv": self.dense(3 * dim),
                                           "out": self.dense(dim)}
        blk["LayerNorm_1"] = self.ln(dim)
        if conv_kernel > 0:
            blk["dwconv"] = self.conv1d(dim)
            blk["LayerNorm_2"] = self.ln(dim)
        blk["Dense_0"] = self.dense(dim * ffn_mult)
        blk["Dense_1"] = self.dense(dim)
        return blk

    def drained(self) -> None:
        _drained(self.who, self.denses, self.lns, self.convs)


def _drained(name: str, *queues) -> None:
    left = [f"{q[0].op_type}('{q[0].name}')" for q in queues if q]
    if left:
        raise ValueError(f"{name}: unconsumed weight-bearing ops remain: {left} "
                         "(graph topology does not match the module config)")


# ---------------------------------------------------------------------------
# Speaker embedder (ERes2Net-style): models/speaker.SpeakerEmbedder
# ---------------------------------------------------------------------------

def map_speaker_onnx(graph: OnnxGraph, cfg) -> dict:
    """ONNX graph (stem conv/bn -> Res2 blocks -> ASP -> proj, in execution
    order) -> SpeakerEmbedder variables {params, batch_stats}.

    Replaces the reference's sherpa-onnx SpeakerEmbeddingExtractor session
    build (src/model.py:103-124) with a weight conversion.
    """
    m = GraphMapper(graph)
    convs = deque(graph.ops("Conv"))
    bns = deque(graph.ops("BatchNormalization"))
    denses = deque(graph.ops("Gemm", "MatMul"))

    def conv(out_ch):
        if not convs:
            raise ValueError("speaker map: ran out of Conv nodes")
        return m.conv2d(convs.popleft(), out_ch)

    def bn(ch):
        if not bns:
            raise ValueError("speaker map: ran out of BatchNormalization nodes")
        return m.batchnorm(bns.popleft(), ch)

    def dense(out_dim):
        if not denses:
            raise ValueError("speaker map: ran out of Gemm/MatMul nodes")
        return m.dense(denses.popleft(), out_dim)

    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}
    params["stem"] = conv(cfg.channels[0])
    params["bn0"], stats["bn0"] = bn(cfg.channels[0])
    cin = cfg.channels[0]
    for i, ch in enumerate(cfg.channels):
        stride = 1 if i == 0 else 2
        bp: Dict[str, dict] = {}
        bs: Dict[str, dict] = {}
        bp["in_conv"] = conv(ch)
        bp["bn_in"], bs["bn_in"] = bn(ch)
        width = ch // cfg.scale
        for j in range(1, cfg.scale):
            bp[f"conv_{j}"] = conv(width)
            bp[f"bn_{j}"], bs[f"bn_{j}"] = bn(width)
        bp["out_conv"] = conv(ch)
        bp["bn_out"], bs["bn_out"] = bn(ch)
        if stride > 1 or cin != ch:
            bp["short"] = conv(ch)
        params[f"block_{i}"] = bp
        stats[f"block_{i}"] = bs
        cin = ch
    def peek_out_dim() -> int:
        """Out-dim of the next queued Dense (ASP's hidden width isn't in the
        module config, so read it off the graph)."""
        if not denses:
            raise ValueError("speaker map: missing attentive-pooling Dense nodes")
        n = denses[0]
        w = m.need(n.inputs[1], "Dense weight")
        if n.op_type == "Gemm" and int(n.attrs.get("transB", 0)):
            return int(w.shape[0])
        return int(w.shape[1])

    params["asp"] = {"Dense_0": dense(peek_out_dim())}
    params["asp"]["Dense_1"] = dense(peek_out_dim())
    params["proj"] = dense(cfg.embed_dim)
    _drained("speaker map", convs, bns, denses)
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# SenseVoice CTC encoder: models/asr/sensevoice.SenseVoiceEncoder
# ---------------------------------------------------------------------------

def map_sensevoice_onnx(graph: OnnxGraph, cfg) -> dict:
    """ONNX graph -> SenseVoiceEncoder variables {params}.

    Execution-order convention per block: ln -> qkv -> out -> ln -> dwconv
    -> ln -> ffn_up -> ffn_down; then final ln + ctc head. Prompt embeddings
    are identified by usage: lang/itn matrices feed Gather nodes, the
    prompt pad feeds a Concat directly. Handles the int8 export through
    DequantizeLinear resolution (the reference ships SenseVoice int8,
    install.sh:57-61).
    """
    from ..models.asr.sensevoice import LANGUAGES

    q = _QueueSet(graph, "sensevoice map")
    m = q.m
    params: Dict[str, object] = {}
    params["in_proj"] = q.dense(cfg.dim)

    # prompt embeddings by usage + shape
    lang = itn = pad = None
    for n in graph.ops("Gather"):
        t = m.tensor(n.inputs[0])
        if t is None or t.ndim != 2 or t.shape[1] != cfg.dim:
            continue
        if t.shape[0] == len(LANGUAGES):
            lang = t
        elif t.shape[0] == 2:
            itn = t
    for n in graph.ops("Concat"):
        for i in n.inputs:
            t = m.tensor(i)
            if (t is not None and t.ndim == 2
                    and t.shape == (cfg.num_prompt - 2, cfg.dim)
                    and not any(c.op_type == "Gather" and c.inputs[0] == i
                                for c in m.consumers.get(i, []))):
                pad = t
    if lang is None or itn is None or pad is None:
        raise ValueError("sensevoice map: prompt embeddings not found "
                         f"(lang={lang is not None}, itn={itn is not None}, "
                         f"pad={pad is not None})")
    params["lang_embed"] = lang.astype(np.float32)
    params["itn_embed"] = itn.astype(np.float32)
    params["prompt_pad"] = pad.astype(np.float32)

    for i in range(cfg.layers):
        params[f"block_{i}"] = q.transformer_block(cfg.dim, cfg.ffn_mult, cfg.conv_kernel)
    params["final_ln"] = q.ln(cfg.dim)
    params["ctc_head"] = q.dense(cfg.vocab_size)
    q.drained()
    return {"params": params}


# ---------------------------------------------------------------------------
# VAD: models/vad.VADNet
# ---------------------------------------------------------------------------

def map_vad_onnx(graph: OnnxGraph, cfg) -> dict:
    """ONNX graph (dilated Conv1d stack + head) -> VADNet variables
    (silero-VAD slot, reference sp-id script:510-520)."""
    m = GraphMapper(graph)
    convs = deque(graph.ops("Conv"))
    denses = deque(graph.ops("Gemm", "MatMul"))
    params: Dict[str, dict] = {}
    for i in range(cfg.layers):
        if not convs:
            raise ValueError("vad map: ran out of Conv nodes")
        params[f"conv_{i}"] = m.conv1d(convs.popleft(), cfg.dim)
    if not denses:
        raise ValueError("vad map: missing head Gemm/MatMul")
    params["head"] = m.dense(denses.popleft(), 1)
    _drained("vad map", convs, denses)
    return {"params": params}


# ---------------------------------------------------------------------------
# Paraformer (CIF): models/asr/paraformer.Paraformer
# ---------------------------------------------------------------------------

def map_paraformer_onnx(graph: OnnxGraph, cfg) -> dict:
    """in_proj -> encoder transformer blocks (conformer-flavored) -> enc_ln
    -> CIF predictor (hidden + scalar firing head) -> NAR decoder blocks
    (no conv branch) -> dec_ln -> vocab head, all in execution order
    (reference family: src/model.py:69-78, from_paraformer)."""
    q = _QueueSet(graph, "paraformer map")
    params: Dict[str, object] = {"in_proj": q.dense(cfg.dim)}
    for i in range(cfg.enc_layers):
        params[f"enc_{i}"] = q.transformer_block(cfg.dim, cfg.ffn_mult, cfg.conv_kernel)
    params["enc_ln"] = q.ln(cfg.dim)
    params["cif_hidden"] = q.dense(cfg.dim)
    params["cif_out"] = q.dense(1)
    for i in range(cfg.dec_layers):
        params[f"dec_{i}"] = q.transformer_block(cfg.dim, cfg.ffn_mult, 0)
    params["dec_ln"] = q.ln(cfg.dim)
    params["out"] = q.dense(cfg.vocab_size)
    q.drained()
    return {"params": params}


# ---------------------------------------------------------------------------
# Transducer (encoder / predictor / joiner): models/asr/transducer.Transducer
# ---------------------------------------------------------------------------

def map_transducer_onnx(graph: OnnxGraph, cfg) -> dict:
    """One combined graph in execution order: encoder (2 subsampling convs,
    transformer blocks, out_ln), predictor (embedding Gather + proj), joiner
    (enc_proj, pred_proj, out). The reference ships the three as separate
    ONNX files (src/model.py:88-99 from_transducer); concatenate their
    nodes when importing sherpa-style exports."""
    q = _QueueSet(graph, "transducer map")
    m = q.m
    enc: Dict[str, object] = {}
    enc["sub1"] = q.conv1d(cfg.dim)
    enc["sub2"] = q.conv1d(cfg.dim)
    for i in range(cfg.layers):
        enc[f"block_{i}"] = q.transformer_block(cfg.dim, cfg.ffn_mult, cfg.conv_kernel)
    enc["out_ln"] = q.ln(cfg.dim)

    emb = None
    for n in graph.ops("Gather"):
        t = m.tensor(n.inputs[0])
        if t is not None and t.ndim == 2 and t.shape == (cfg.vocab_size, cfg.pred_dim):
            emb = t
            break
    if emb is None:
        raise ValueError(
            f"transducer map: predictor embedding Gather ({cfg.vocab_size}, "
            f"{cfg.pred_dim}) not found")
    predictor = {"embed": {"embedding": emb.astype(np.float32)},
                 "proj": q.dense(cfg.pred_dim)}
    joiner = {"enc_proj": q.dense(cfg.joiner_dim),
              "pred_proj": q.dense(cfg.joiner_dim),
              "out": q.dense(cfg.vocab_size)}
    q.drained()
    return {"params": {"encoder": enc, "predictor": predictor, "joiner": joiner}}


# ---------------------------------------------------------------------------
# Whisper-style encoder-decoder: models/asr/whisper_style.WhisperStyle
# ---------------------------------------------------------------------------

def map_whisper_onnx(graph: OnnxGraph, cfg) -> dict:
    """One combined graph, encoder ops then decoder ops in execution order
    (reference registers whisper via from_whisper(encoder, decoder) —
    sp-id script:316-345; concatenate the two graphs' nodes when they ship
    as separate files).

    Per encoder block: ln -> qkv -> out -> ln -> ffn_up -> ffn_down.
    Decoder: token-embedding Gather, then per block: ln1 -> self qkv/out ->
    ln2 -> cross q/k/v/out -> ln3 -> fc1 -> fc2; final dec_ln. Output logits
    are tied to the embedding (no separate head matmul is consumed).
    """
    m = GraphMapper(graph)
    denses = deque(graph.ops("Gemm", "MatMul"))
    lns = deque(graph.ops("LayerNormalization"))
    convs = deque(graph.ops("Conv"))

    def dense(out_dim):
        if not denses:
            raise ValueError("whisper map: ran out of Gemm/MatMul nodes")
        return m.dense(denses.popleft(), out_dim)

    def ln():
        if not lns:
            raise ValueError("whisper map: ran out of LayerNormalization nodes")
        return m.layernorm(lns.popleft(), cfg.dim)

    params: Dict[str, object] = {}
    if len(convs) < 2:
        raise ValueError("whisper map: expected 2 subsampling Conv nodes")
    params["sub1"] = m.conv1d(convs.popleft(), cfg.dim)
    params["sub2"] = m.conv1d(convs.popleft(), cfg.dim)
    for i in range(cfg.enc_layers):
        blk: Dict[str, object] = {"LayerNorm_0": ln()}
        blk["attn"] = {"qkv": dense(3 * cfg.dim), "out": dense(cfg.dim)}
        blk["LayerNorm_1"] = ln()
        up = dense(cfg.dim * cfg.ffn_mult)
        down = dense(cfg.dim)
        # flax construction-order naming: Dense_0 is the DOWN projection
        blk["Dense_0"] = down
        blk["Dense_1"] = up
        params[f"enc_{i}"] = blk
    params["enc_ln"] = ln()

    emb = None
    for n in graph.ops("Gather"):
        t = m.tensor(n.inputs[0])
        if t is not None and t.ndim == 2 and t.shape == (cfg.vocab_size, cfg.dim):
            emb = t
            break
    if emb is None:
        raise ValueError(
            f"whisper map: token embedding Gather ({cfg.vocab_size}, {cfg.dim}) not found")
    params["tok_embed"] = {"embedding": emb.astype(np.float32)}

    for i in range(cfg.dec_layers):
        blk = {"ln1": ln()}
        blk["self_attn"] = {"qkv": dense(3 * cfg.dim), "out": dense(cfg.dim)}
        blk["ln2"] = ln()
        blk["cross_attn"] = {"q": dense(cfg.dim), "k": dense(cfg.dim),
                             "v": dense(cfg.dim), "out": dense(cfg.dim)}
        blk["ln3"] = ln()
        blk["fc1"] = dense(cfg.dim * cfg.ffn_mult)
        blk["fc2"] = dense(cfg.dim)
        params[f"dec_{i}"] = blk
    params["dec_ln"] = ln()
    _drained("whisper map", denses, lns, convs)
    return {"params": params}


# ---------------------------------------------------------------------------
# MossFormer separator: models/mossformer.MossFormer
# ---------------------------------------------------------------------------

def map_mossformer_onnx(graph: OnnxGraph, cfg) -> dict:
    """Conv encoder -> in_proj -> GAU layers (ln, dwconv, to_u/to_v/to_qk,
    per-layer (2, qk_dim) gamma via Mul / beta via Add, to_out) -> ln_out ->
    mask head -> ConvTranspose decoder. Fills the ModelScope MossFormer
    weight slot (reference: src/mossformer/infer.py:13-23)."""
    m = GraphMapper(graph)
    denses = deque(graph.ops("Gemm", "MatMul"))
    lns = deque(graph.ops("LayerNormalization"))
    convs = deque(graph.ops("Conv"))
    # per-layer qk scale/offset pairs, identified by usage
    gammas = deque(n for n in graph.ops("Mul")
                   if (t := m.tensor(n.inputs[1])) is not None
                   and t.shape == (2, cfg.qk_dim))
    betas = deque(n for n in graph.ops("Add")
                  if (t := m.tensor(n.inputs[1])) is not None
                  and t.shape == (2, cfg.qk_dim))

    def dense(out_dim):
        if not denses:
            raise ValueError("mossformer map: ran out of Gemm/MatMul nodes")
        return m.dense(denses.popleft(), out_dim)

    def chan_ln():
        if not lns:
            raise ValueError("mossformer map: ran out of LayerNormalization nodes")
        p = m.layernorm(lns.popleft(), cfg.dim)
        return {"gamma": p["scale"], "beta": p["bias"]}

    params: Dict[str, object] = {}
    if not convs:
        raise ValueError("mossformer map: missing encoder Conv")
    enc = m.conv1d(convs.popleft(), cfg.enc_dim)
    params["encoder"] = {"kernel": enc["kernel"]}  # encoder has no bias
    params["in_proj"] = dense(cfg.dim)
    d_e = cfg.dim * cfg.expansion
    for i in range(cfg.layers):
        blk: Dict[str, object] = {"ln": chan_ln()}
        if not convs:
            raise ValueError("mossformer map: ran out of dwconv Conv nodes")
        blk["dwconv"] = m.conv1d(convs.popleft(), cfg.dim)
        blk["to_u"] = dense(d_e)
        blk["to_v"] = dense(d_e)
        blk["to_qk"] = dense(cfg.qk_dim)
        if not gammas or not betas:
            raise ValueError("mossformer map: missing (2, qk_dim) gamma/beta pair")
        blk["gamma"] = m.need(gammas.popleft().inputs[1], "gamma").astype(np.float32)
        blk["beta"] = m.need(betas.popleft().inputs[1], "beta").astype(np.float32)
        blk["to_out"] = dense(cfg.dim)
        params[f"gau_{i}"] = blk
    params["ln_out"] = chan_ln()
    params["mask_head"] = dense(cfg.n_src * cfg.enc_dim)
    dec_nodes = graph.ops("ConvTranspose")
    if not dec_nodes:
        raise ValueError("mossformer map: missing ConvTranspose decoder")
    dec_w = m.need(dec_nodes[0].inputs[1], "decoder weight")  # [N, 1, L]
    if dec_w.shape != (cfg.enc_dim, 1, cfg.enc_kernel):
        raise ValueError(f"mossformer map: decoder weight {dec_w.shape} != "
                         f"({cfg.enc_dim}, 1, {cfg.enc_kernel})")
    params["decoder"] = np.ascontiguousarray(dec_w[:, 0, :].T, np.float32)
    _drained("mossformer map", denses, lns, convs, gammas, betas)
    return {"params": params}


MAPPERS = {
    "speaker": map_speaker_onnx,
    "sensevoice": map_sensevoice_onnx,
    "vad": map_vad_onnx,
    "whisper": map_whisper_onnx,
    "mossformer": map_mossformer_onnx,
    "paraformer": map_paraformer_onnx,
    "transducer": map_transducer_onnx,
}


def import_onnx(path, target: str, cfg) -> dict:
    """Map ONNX file(s) onto the `target` module's variables.

    ``path`` may be a list of files (e.g. the transducer's encoder/decoder/
    joiner, or whisper's encoder+decoder): their nodes and initializers are
    concatenated in the given order before the structural walk."""
    from .onnx_import import load_onnx_graph

    if target not in MAPPERS:
        raise ValueError(f"unknown map target '{target}' (have {sorted(MAPPERS)})")
    paths = [path] if isinstance(path, (str, bytes)) else list(path)
    graphs = [load_onnx_graph(p) for p in paths]
    merged = graphs[0]
    for g in graphs[1:]:
        merged.nodes.extend(g.nodes)
        merged.initializers.update(g.initializers)
    return MAPPERS[target](merged, cfg)


def import_onnx_state_dict(path, target: str, cfg) -> dict:
    """``import_onnx`` onto the port's module: the mapped tree as the
    ``state_dict`` of the stage's module (convert/from_jax)."""
    from .from_jax import variables_to_state_dict

    return variables_to_state_dict(import_onnx(path, target, cfg))
