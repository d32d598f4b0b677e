"""Model-zoo asset loaders: CMVN statistics from a kaldi / FunASR ``am.mvn``
(port of audio_classification_tpu/models/convert/assets.py).

The reference's SenseVoice and Paraformer recognizers normalise their LFR
features with the model directory's ``am.mvn`` (reference: src/model.py:79-87,
install.sh:57-61). ``load_kaldi_cmvn`` parses that file for the port's
frontends, which apply y = (x + shift) * scale (``ModelPack(cmvn=...)``).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Tuple

import numpy as np

_VEC = re.compile(r"\[([^\]]*)\]")


def load_kaldi_cmvn(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a kaldi / FunASR ``am.mvn`` -> (add_shift, rescale) float32.

    Expected structure (whitespace and newlines free-form):
        <Nnet> ... <AddShift> D D <LearnRateCoef> 0 [ ...D floats... ]
               <Rescale> D D <LearnRateCoef> 0 [ ...D floats... ] </Nnet>

    Also accepts a bare two-vector file: the first ``[...]`` is the shift
    (negative mean), the second the scale (inverse stddev).
    """
    text = Path(path).read_text(encoding="utf-8", errors="replace")

    def vec_after(tag: str):
        i = text.find(tag)
        if i < 0:
            return None
        m = _VEC.search(text, i)
        if m is None:
            return None
        vals = [float(x) for x in m.group(1).split()]
        return np.asarray(vals, np.float32) if vals else None

    shift = vec_after("<AddShift>")
    scale = vec_after("<Rescale>")
    if shift is None or scale is None:
        # bare form: the first two non-empty bracketed vectors
        vecs = [np.asarray([float(x) for x in m.split()], np.float32)
                for m in _VEC.findall(text) if m.split()]
        if len(vecs) < 2:
            raise ValueError(f"{path}: expected <AddShift>/<Rescale> vectors or two bare "
                             "[...] vectors (kaldi am.mvn format)")
        shift, scale = vecs[0], vecs[1]
    if shift.shape != scale.shape:
        raise ValueError(f"{path}: shift dim {shift.shape} != scale dim {scale.shape}")
    return shift, scale
