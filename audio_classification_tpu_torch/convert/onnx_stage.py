"""Serve reference .onnx checkpoints as engine stages (port of
audio_classification_tpu/models/convert/onnx_stage.py).

The reference's entire model zoo is ONNX run by onnxruntime sessions
(reference: src/model.py:79-124 builds sherpa-onnx recognizer / extractor
sessions over the files from install.sh:52-61). The graph-aware importers
(onnx_graph_map) translate a graph's weights onto the port's own modules,
exact only when topologies line up. ``OnnxStage`` removes that restriction:
it wraps convert/onnx_exec.OnnxModel so the *exported graph itself* runs as
the engine's stage, on the engine's device, between the engine's frontend
(K1 in front of every stage) and its decode epilogue.

Feed mapping is inferred from the graph signature (override via kwargs):

* the float input with the highest declared rank receives the features
  (fbank [B,T,80] for speaker models, LFR+CMVN stacks [B,T,560] for
  SenseVoice, matching what sherpa-onnx's C++ frontend feeds the session),
* an integer input whose name contains ``len`` receives true frame counts
  (mask row-sums), so padded batching stays exact,
* remaining integer vector inputs are prompt scalars broadcast to [B]:
  names containing ``lang`` get the language id, names containing
  ``norm``/``itn`` get the inverse-text-normalization flag (SenseVoice's
  ``language``/``textnorm`` inputs, reference src/model.py:79-87).

Graphs WITHOUT a length input cannot see true lengths; padded frames are
zeroed, which matches exactly at bucket-boundary lengths and approximates
otherwise (the reference runs one utterance per session call, so it never
pads). A note is printed once for such graphs.

The transducer and whisper decoders loop over frames / tokens on device
tensors, as the port's own decoders do (JAX runs each as one ``lax.scan``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .onnx_exec import OnnxModel


def _classify_inputs(graph):
    """Graph runtime inputs -> (float_names, int_names, ranks)."""
    ranks: Dict[str, int] = {}
    float_in, int_in = [], []
    for vi in graph.inputs:
        if vi.name in graph.initializers:
            continue
        ranks[vi.name] = len(vi.shape)
        if vi.dtype is not None and np.issubdtype(vi.dtype, np.integer):
            int_in.append(vi.name)
        else:
            float_in.append(vi.name)
    return float_in, int_in, ranks


def _model(m, device) -> OnnxModel:
    return m if isinstance(m, OnnxModel) else OnnxModel(m, device=device)


class OnnxStage:
    """An OnnxModel bound to the engine's (params, feats, mask) calling
    convention.

    ``skip_frames`` drops that many leading output frames before CTC decode
    (the real SenseVoice export emits its 4 prompt positions in the logits;
    sherpa-onnx's decoder skips them the same way). ``device`` is the
    OnnxModel's when a path is given (the card by default).
    """

    family = "generic"

    def __init__(self, model, skip_frames: int = 0,
                 feats_input: Optional[str] = None,
                 length_input: Optional[str] = None,
                 output: Optional[str] = None,
                 n_outputs: int = 1,
                 prompts: Optional[Dict[str, int]] = None,
                 verbose: bool = True, device=None):
        self.model = _model(model, device)
        self.device = self.model.device
        self.params = self.model.params
        self.skip_frames = int(skip_frames)
        self.prompts = dict(prompts or {})
        g = self.model.graph
        float_inputs, int_inputs, ranks = _classify_inputs(g)

        if feats_input is not None:
            self.feats_input = feats_input
        elif float_inputs:
            self.feats_input = max(float_inputs, key=lambda n: ranks[n])
        elif self.model.input_names:
            self.feats_input = self.model.input_names[0]
        else:
            raise ValueError("ONNX graph declares no runtime inputs")

        if length_input is not None:
            self.length_input = length_input or None
        else:
            lens = [n for n in int_inputs if "len" in n.lower()]
            self.length_input = lens[0] if lens else None
        self.int_inputs = [
            n for n in int_inputs
            if n != self.length_input and n != self.feats_input
        ]
        if output is not None:
            self.outputs = [output]
        else:
            self.outputs = list(g.output_names[: max(1, int(n_outputs))])
        if not self.outputs:
            raise ValueError("ONNX graph declares no outputs")
        self.output = self.outputs[0]
        if self.length_input is None and verbose:
            print(f"[onnx_stage] graph '{g.name or self.feats_input}' has no "
                  f"length input; padded frames are zeroed (exact at bucket-"
                  f"boundary lengths)")

    def _prompt_value(self, name: str, language_id: int, use_itn: bool) -> int:
        low = name.lower()
        if name in self.prompts:
            return self.prompts[name]
        if "lang" in low:
            return int(language_id)
        if "norm" in low or "itn" in low:
            return 1 if use_itn else 0
        return 0

    def __call__(self, params, feats, mask, *, language_id: int = 0,
                 use_itn: bool = True):
        """feats [B, T, D] (+ frame mask [B, T]) -> first graph output
        (float32; a tuple of the first ``n_outputs``)."""
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        m = torch.as_tensor(mask, device=self.device)
        mf = m.to(feats.dtype)
        feeds = {
            self.feats_input: feats * (mf[..., None] if feats.ndim == m.ndim + 1 else mf)
        }
        if self.length_input is not None:
            feeds[self.length_input] = m.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        for name in self.int_inputs:
            v = self._prompt_value(name, language_id, use_itn)
            # honor a concretely declared shape (e.g. this framework's own
            # exports take language as [1]); symbolic/absent dims -> [B]
            shape = (feats.shape[0],)
            for vi in self.model.graph.inputs:
                if vi.name == name and vi.shape and all(
                        isinstance(d, int) for d in vi.shape):
                    shape = tuple(vi.shape)
                    break
            feeds[name] = torch.full(shape, v, dtype=torch.int32, device=self.device)
        outs = self.model.raw_fn(params, feeds)
        result = []
        for i, name in enumerate(self.outputs):
            out = outs[name].float()
            if self.skip_frames and i == 0 and out.ndim >= 2:
                out = out[:, self.skip_frames:]
            result.append(out)
        return tuple(result) if len(result) > 1 else result[0]

    def describe(self) -> str:
        return (f"OnnxStage(feats={self.feats_input!r}, "
                f"lengths={self.length_input!r}, ints={self.int_inputs}, "
                f"out={self.outputs}, skip_frames={self.skip_frames})\n"
                + self.model.describe())


class OnnxTransducerStage:
    """The reference's transducer triple, encoder/decoder/joiner .onnx files
    (src/model.py:88-99, ``OfflineRecognizer.from_transducer``), decoded on
    the device: at most one emitted symbol per frame (sherpa / icefall
    greedy default), the stateless predictor's context re-fed through the
    decoder graph, one loop over frames (JAX: one lax.scan).

    Signature heuristics per graph (same rules as OnnxStage):
      encoder: highest-rank float input = features, int ``*len*`` input =
        frame counts; first non-``len`` output = encoder frames, a ``len``
        output (if any) = valid output frames (else scaled from the input).
      decoder: its single int input takes the [B, context] token window
        (context read from the declared shape, default 2).
      joiner: two float inputs matched by name (``enc``/``dec`` substrings),
        falling back to declaration order.
    """

    family = "transducer"

    def __init__(self, encoder, decoder, joiner, blank_id: int = 0,
                 context_size: int = 0, device=None):
        self.enc = _model(encoder, device)
        self.device = self.enc.device
        self.dec = _model(decoder, self.device)
        self.join = _model(joiner, self.device)
        self.params = {"encoder": self.enc.params, "decoder": self.dec.params,
                       "joiner": self.join.params}
        self.blank_id = int(blank_id)
        self.outputs = ["ids", "lengths"]

        ef, ei, er = _classify_inputs(self.enc.graph)
        if not ef:
            raise ValueError("transducer encoder graph has no float input")
        self.enc_feats = max(ef, key=lambda n: er[n])
        lens = [n for n in ei if "len" in n.lower()]
        self.enc_lens_in = lens[0] if lens else None
        outs = self.enc.graph.output_names
        non_len = [n for n in outs if "len" not in n.lower()]
        self.enc_out = non_len[0] if non_len else outs[0]
        len_outs = [n for n in outs if "len" in n.lower()]
        self.enc_lens_out = len_outs[0] if len_outs else None

        df, di, _ = _classify_inputs(self.dec.graph)
        dec_ins = di or df  # some exports declare y as int64, some leave it untyped
        if not dec_ins:
            raise ValueError("transducer decoder graph has no runtime input")
        self.dec_y = dec_ins[0]
        self.dec_out = self.dec.graph.output_names[0]
        if context_size:
            self.context = int(context_size)
        else:
            shp = next((vi.shape for vi in self.dec.graph.inputs
                        if vi.name == self.dec_y), [])
            last = shp[-1] if shp else None
            self.context = int(last) if isinstance(last, int) and last > 0 else 2

        jf, _, _ = _classify_inputs(self.join.graph)
        if len(jf) < 2:
            raise ValueError("transducer joiner graph needs two float inputs")
        enc_named = [n for n in jf if "enc" in n.lower()]
        dec_named = [n for n in jf if "dec" in n.lower() or "pred" in n.lower()]
        self.join_enc = enc_named[0] if enc_named else jf[0]
        self.join_dec = (dec_named[0] if dec_named
                         else next(n for n in jf if n != self.join_enc))
        self.join_out = self.join.graph.output_names[0]

    def _predict(self, params, ctx):
        outs = self.dec.raw_fn(params["decoder"], {self.dec_y: ctx})
        d = outs[self.dec_out]
        if d.ndim == 3:  # [B, 1, D] exports
            d = d[:, 0]
        return d

    def _joint(self, params, e_t, pred):
        return self.join.raw_fn(params["joiner"],
                                {self.join_enc: e_t, self.join_dec: pred})[self.join_out]

    def decode(self, params, feats, mask, beam: int = 0):
        """[B, T, mel] feats + frame mask -> (ids [B, T'], lengths [B]),
        the same contract as Transducer.greedy_decode.

        ``beam > 1`` runs modified beam search over the export's own
        decoder / joiner graphs (reference: src/model.py:47-99 routes
        ``decoding_method="modified_beam_search"`` + ``num_active_paths``
        to sherpa-onnx's beam decoder): the beam axis folds into the
        graphs' batch dim ([B*K] calls), one top-k over beam*vocab
        candidates per frame, then a backtrack: the search of
        models/asr/transducer.Transducer.beam_decode."""
        from ..models.asr.beam import left_pack_symbols

        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        m = torch.as_tensor(mask, device=self.device)
        in_len = m.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        feeds = {self.enc_feats: feats * m.to(feats.dtype)[..., None]}
        if self.enc_lens_in is not None:
            feeds[self.enc_lens_in] = in_len
        enc_outs = self.enc.raw_fn(params["encoder"], feeds)
        enc = enc_outs[self.enc_out].float()  # [B, T', D]
        b, t = enc.shape[0], enc.shape[1]
        if self.enc_lens_out is not None:
            out_len = enc_outs[self.enc_lens_out].to(torch.int32)
        else:
            # no declared output lengths: scale by the graph's subsampling
            t_in = max(feats.shape[1], 1)
            out_len = torch.clamp_max(torch.div(in_len * t + t_in - 1, t_in,
                                                rounding_mode="floor"), t)
        omask = torch.arange(t, device=self.device)[None, :] < out_len[:, None]

        if beam and beam > 1:
            return self._beam_search(params, enc, omask, int(beam))

        ctx = torch.full((b, self.context), self.blank_id, dtype=torch.int32,
                         device=self.device)
        count = torch.zeros((b,), dtype=torch.int32, device=self.device)
        syms = []
        for i in range(t):
            logits = self._joint(params, enc[:, i], self._predict(params, ctx))
            sym = logits.argmax(dim=-1).to(torch.int32)
            emit = (sym != self.blank_id) & omask[:, i]
            ctx = torch.where(emit[:, None], torch.cat([ctx[:, 1:], sym[:, None]], dim=1), ctx)
            count = count + emit.to(torch.int32)
            syms.append(torch.where(emit, sym, self.blank_id))
        stacked = (torch.stack(syms, dim=1) if syms
                   else torch.zeros((b, 0), dtype=torch.int32, device=self.device))
        packed, _ = left_pack_symbols(stacked, self.blank_id)
        return packed, count

    def _beam_search(self, params, enc, omask, k: int):
        """Modified beam search over the export graphs (see ``decode``): the
        search core is models/asr/beam.modified_beam_search, shared with the
        port's own transducer; this method supplies the scoring callback
        that folds the beam axis into the graphs' batch dim ([B*K] calls)."""
        from ..models.asr.beam import modified_beam_search

        b, _, d = enc.shape

        def score(e_t, ctx):  # [B, D], [B, K, context] -> [B, K, V]
            pred = self._predict(params, ctx.reshape(b * k, self.context))
            e_bk = e_t[:, None, :].expand(b, k, d).reshape(b * k, d)
            logits = self._joint(params, e_bk, pred)              # [B*K, V]
            return logits.reshape(b, k, logits.shape[-1])

        return modified_beam_search(enc, omask, score, blank_id=self.blank_id,
                                    context=self.context, beam=k)

    def describe(self) -> str:
        return (f"OnnxTransducerStage(context={self.context}, "
                f"blank={self.blank_id})\n"
                f"- encoder: {self.enc.describe()}\n"
                f"- decoder: {self.dec.describe()}\n"
                f"- joiner:  {self.join.describe()}")


class OnnxWhisperStage:
    """The reference's Whisper encoder/decoder .onnx pair (reference:
    speaker-identification-...py:316-345, ``from_whisper``), decoded
    greedily on the device with the export's own KV caches.

    The C++ recognizer loops the decoder session per output token on the
    host; here the autoregressive search is one loop over tokens on device
    tensors (JAX: one lax.scan). The cache tensors the export threads
    through its IO (``in_*`` -> ``out_*``) are carried from step to step,
    so this supports fixed-size-cache exports (sherpa-style).

    Signature heuristics:
      encoder: float input is the mel spectrogram, fed channels-first
        [B, mel, T] when the declared shape has ``num_mel`` second
        (whisper convention), else [B, T, mel]; an integer declared time
        dim (whisper's 3000) pads/trims the features to it.
      decoder: the int input containing ``token`` takes token ids, one
        containing ``offset`` the decode position; float inputs whose
        names match encoder outputs are wired from the encoder
        (cross-attention K/V); remaining float inputs are self-attention
        caches, paired to decoder outputs by the ``in_``->``out_`` naming
        or by position.
    """

    family = "whisper"

    def __init__(self, encoder, decoder, sot_sequence=(1,), eot_id: int = 2,
                 max_decode_len: int = 96, num_mel: int = 80,
                 language: Optional[str] = None, task: str = "transcribe",
                 verbose: bool = True, device=None):
        # sherpa whisper exports carry their token ids in the encoder's
        # metadata_props (sot/sot_sequence/eot/no_timestamps/n_mels +
        # language token tables), exactly what sherpa-onnx's C++ reads to
        # configure itself. When present, metadata WINS over the argument
        # defaults (arguments remain the fallback for plain exports).
        meta = {}
        if isinstance(encoder, str):
            from .onnx_import import load_onnx_metadata

            meta = load_onnx_metadata(encoder)
        self.enc = _model(encoder, device)
        self.device = self.enc.device
        self.dec = _model(decoder, self.device)
        self.params = {"encoder": self.enc.params, "decoder": self.dec.params}
        sot = tuple(int(t) for t in sot_sequence)
        eot, mel = int(eot_id), int(num_mel)
        if meta.get("sot_sequence"):
            sot = tuple(int(t) for t in meta["sot_sequence"].split(",") if t)
        elif meta.get("sot"):
            sot = (int(meta["sot"]),)
        if meta.get("eot"):
            eot = int(meta["eot"])
        if meta.get("n_mels"):
            mel = int(meta["n_mels"])
        if language and meta.get("all_language_codes"):
            codes = meta["all_language_codes"].split(",")
            toks = [int(t) for t in meta.get("all_language_tokens", "").split(",") if t]
            if language in codes and len(toks) == len(codes) and len(sot) >= 2:
                # sot_sequence layout: [sot, language, task]
                sot = (sot[0], toks[codes.index(language)]) + sot[2:]
        if task == "translate" and meta.get("translate") and len(sot) >= 3:
            sot = sot[:2] + (int(meta["translate"]),) + sot[3:]
        if meta.get("no_timestamps"):
            nt = int(meta["no_timestamps"])
            if nt not in sot:
                sot = sot + (nt,)  # sherpa appends it after the task token
        self.sot = sot
        self.eot = eot
        self.max_decode_len = int(max_decode_len)
        self.num_mel = mel
        self.outputs = ["ids", "lengths"]
        if meta and verbose:
            print(f"[onnx_stage] whisper metadata: sot={self.sot} "
                  f"eot={self.eot} n_mels={self.num_mel}")

        ef, _, er = _classify_inputs(self.enc.graph)
        if not ef:
            raise ValueError("whisper encoder graph has no float input")
        self.enc_mel = max(ef, key=lambda n: er[n])
        mel_shape = next((vi.shape for vi in self.enc.graph.inputs
                          if vi.name == self.enc_mel), [])
        self.channels_first = True
        self.static_t = None
        if len(mel_shape) == 3:
            if mel_shape[2] == self.num_mel:
                self.channels_first = False
                if isinstance(mel_shape[1], int):
                    self.static_t = mel_shape[1]
            elif isinstance(mel_shape[2], int) and mel_shape[1] == self.num_mel:
                self.static_t = mel_shape[2]
        enc_out_names = set(self.enc.graph.output_names)

        df, di, _ = _classify_inputs(self.dec.graph)
        toks = [n for n in di if "token" in n.lower()]
        self.tokens_in = toks[0] if toks else (di[0] if di else None)
        if self.tokens_in is None:
            raise ValueError("whisper decoder graph has no int token input")
        offs = [n for n in di if "offset" in n.lower()]
        self.offset_in = offs[0] if offs else None
        self.cross_names = [n for n in df if n in enc_out_names]
        cache_ins = [n for n in df if n not in enc_out_names]
        outs = self.dec.graph.output_names
        logit_outs = [n for n in outs if "logit" in n.lower()]
        self.logits_out = logit_outs[0] if logit_outs else outs[0]
        cache_outs = [n for n in outs if n != self.logits_out]
        self.cache_map: Dict[str, str] = {}
        for cin in cache_ins:
            want = cin.replace("in_", "out_", 1) if cin.startswith("in_") else None
            if want in cache_outs:
                self.cache_map[cin] = want
        unmatched_in = [n for n in cache_ins if n not in self.cache_map]
        unmatched_out = [n for n in cache_outs
                         if n not in self.cache_map.values()]
        for cin, cout in zip(unmatched_in, unmatched_out):
            self.cache_map[cin] = cout
        if len(self.cache_map) != len(cache_ins):
            raise ValueError(
                f"cannot pair decoder cache inputs {cache_ins} with outputs "
                f"{cache_outs}")
        # cache allocation shapes from the declared signature: ints stay,
        # the first symbolic dim is the batch, any other symbolic dim is
        # the cache length (max_decode_len + sot)
        self._cache_decl = {
            n: next((vi.shape for vi in self.dec.graph.inputs if vi.name == n),
                    [])
            for n in cache_ins
        }

    def _cache_shape(self, decl, b: int):
        shape, batch_used = [], False
        for d in decl:
            if isinstance(d, int) and d > 0:
                shape.append(d)
            elif not batch_used:
                shape.append(b)
                batch_used = True
            else:
                shape.append(self.max_decode_len + len(self.sot))
        return tuple(shape)

    def decode(self, params, feats, mask, max_len: Optional[int] = None):
        """[B, T, mel] feats + frame mask -> (ids [B, L], lengths [B]);
        ``max_len`` overrides the decode budget (``max_decode_len``)."""
        dev = self.device
        feats = torch.as_tensor(feats, dtype=torch.float32, device=dev)
        m = torch.as_tensor(mask, device=dev).to(feats.dtype)
        mel = feats * m[..., None]
        b = mel.shape[0]
        if self.channels_first:
            mel = mel.permute(0, 2, 1)  # [B, mel, T]
            t_axis = 2
        else:
            t_axis = 1
        if self.static_t is not None:
            t_now = mel.shape[t_axis]
            if t_now < self.static_t:
                pad = [0, 0] * 3
                pad[2 * (2 - t_axis) + 1] = self.static_t - t_now
                mel = torch.nn.functional.pad(mel, pad)
            elif t_now > self.static_t:
                mel = mel.narrow(t_axis, 0, self.static_t)
        enc_outs = self.enc.raw_fn(params["encoder"], {self.enc_mel: mel})
        cross = {n: enc_outs[n] for n in self.cross_names}

        def dec_call(tokens, offset, caches):
            feeds = {self.tokens_in: tokens}
            if self.offset_in is not None:
                feeds[self.offset_in] = offset
            feeds.update(cross)
            feeds.update(caches)
            outs = self.dec.raw_fn(params["decoder"], feeds)
            logits = outs[self.logits_out].float()
            new_caches = {cin: outs[cout] for cin, cout in self.cache_map.items()}
            return logits, new_caches

        caches = {n: torch.zeros(self._cache_shape(decl, b), dtype=torch.float32, device=dev)
                  for n, decl in self._cache_decl.items()}
        sot = torch.tensor(self.sot, dtype=torch.int32, device=dev)[None].repeat(b, 1)
        logits, caches = dec_call(sot, torch.zeros((b,), dtype=torch.int32, device=dev), caches)
        cur = logits[:, -1].argmax(dim=-1).to(torch.int32)
        done = cur == self.eot
        count = torch.zeros((b,), dtype=torch.int32, device=dev)
        syms = []
        steps = self.max_decode_len if max_len is None else int(max_len)
        for i in range(steps):
            emit = ~done
            syms.append(torch.where(emit, cur, 0))
            count = count + emit.to(torch.int32)
            offset = torch.full((b,), len(self.sot) + i, dtype=torch.int32, device=dev)
            logits, caches = dec_call(cur[:, None], offset, caches)
            nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
            done = done | (nxt == self.eot)
            cur = nxt
        ids = (torch.stack(syms, dim=1) if syms
               else torch.zeros((b, 0), dtype=torch.int32, device=dev))
        return ids, count  # emitted contiguously, 0-padded after EOT

    def describe(self) -> str:
        return (f"OnnxWhisperStage(sot={self.sot}, eot={self.eot}, "
                f"channels_first={self.channels_first}, "
                f"static_t={self.static_t}, caches={self.cache_map})\n"
                f"- encoder: {self.enc.describe()}\n"
                f"- decoder: {self.dec.describe()}")
