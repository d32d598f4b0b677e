"""Token table: sherpa-style ``tokens.txt`` (symbol<space>id per line) (host copy of
audio_classification_tpu/models/asr/tokens.py).

Decoding mirrors sherpa-onnx text assembly: sentencepiece-style pieces use
"▁" as the word boundary; bare CJK chars concatenate; ``<blk>``/``<unk>``
and SenseVoice prompt tokens (``<|zh|>`` etc.) are filtered.

Whisper exports are special: sherpa-onnx whisper tokens.txt (written by its
export-onnx.py from the tiktoken byte-BPE vocabulary; consumed by the
reference via sherpa_onnx.OfflineRecognizer.from_whisper —
/root/reference/scripts/speaker-identification-with-vad-non-streaming-asr.py:331-345)
carries BASE64-ENCODED BYTE SEQUENCES, one per token id.  A single UTF-8
character can span several tokens, so decoding must first assemble the raw
byte buffer across the whole id sequence and only then UTF-8-decode it.
``TokenTable.load(path, base64_tokens=True)`` enables that mode (the engine
sets it for the whisper family); symbols that are not valid base64 (e.g. a
literal ``<|endoftext|>`` line) are kept as literal specials and filtered.
"""
from __future__ import annotations

import base64
import binascii
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional

BLANK_TOKENS = {"<blk>", "<blank>", "<pad>", "<eps>"}
SPECIAL_PREFIX = "<|"
_B64_RE = re.compile(r"^[A-Za-z0-9+/]+={0,2}$")


def _try_b64(sym: str) -> Optional[bytes]:
    """Decode ``sym`` as strict base64, or None if it isn't."""
    if not sym or len(sym) % 4 or not _B64_RE.match(sym):
        return None
    try:
        return base64.b64decode(sym, validate=True)
    except (binascii.Error, ValueError):
        return None


class TokenTable:
    def __init__(self, id_to_sym: Dict[int, str], blank_id: int = 0,
                 id_to_bytes: Optional[Dict[int, bytes]] = None):
        self.id_to_sym = dict(id_to_sym)
        self.sym_to_id = {s: i for i, s in self.id_to_sym.items()}
        self.blank_id = blank_id
        # whisper byte-BPE mode: ids that map to raw byte fragments
        self.id_to_bytes: Dict[int, bytes] = dict(id_to_bytes or {})

    @property
    def vocab_size(self) -> int:
        return max(self.id_to_sym) + 1 if self.id_to_sym else 0

    @property
    def is_byte_bpe(self) -> bool:
        return bool(self.id_to_bytes)

    @classmethod
    def load(cls, path: str | Path,
             base64_tokens: Optional[bool] = None) -> "TokenTable":
        """Load a sherpa-style tokens.txt.

        ``base64_tokens``: True — whisper convention, symbols are base64 byte
        fragments (invalid-base64 lines stay literal specials); False — plain
        symbols; None (default) — auto-detect: byte-BPE mode if every
        non-``<...>`` symbol in the file is strict base64 AND at least one
        decodes to bytes that are not printable ASCII (a plain CJK/BPE vocab
        never satisfies both).
        """
        id_to_sym: Dict[int, str] = {}
        blank_id = 0
        for line in Path(path).read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            # token text may itself contain a space only via the ▁ marker, so
            # rsplit on the last whitespace run
            parts = line.rsplit(None, 1)
            if len(parts) != 2:
                continue
            sym, idx = parts[0], int(parts[1])
            id_to_sym[idx] = sym
            if sym in BLANK_TOKENS:
                blank_id = idx
        if base64_tokens is None:
            base64_tokens = cls._detect_base64(id_to_sym)
        id_to_bytes: Dict[int, bytes] = {}
        if base64_tokens:
            for idx, sym in id_to_sym.items():
                raw = _try_b64(sym)
                if raw is not None:
                    id_to_bytes[idx] = raw
        return cls(id_to_sym, blank_id, id_to_bytes=id_to_bytes)

    @staticmethod
    def _detect_base64(id_to_sym: Dict[int, str]) -> bool:
        saw_non_ascii = False
        for sym in id_to_sym.values():
            if sym.startswith("<") and sym.endswith(">"):
                continue  # literal special line
            raw = _try_b64(sym)
            if raw is None:
                return False
            if any(b < 0x20 or b > 0x7E for b in raw):
                saw_non_ascii = True
        return saw_non_ascii

    @classmethod
    def char_table(cls, chars: str) -> "TokenTable":
        """Tiny synthetic table for tests: blank=0, then one id per char."""
        table = {0: "<blk>"}
        for i, ch in enumerate(sorted(set(chars)), start=1):
            table[i] = ch
        return cls(table, blank_id=0)

    def encode(self, text: str) -> List[int]:
        """Char-level encode (test/synthetic vocab only)."""
        return [self.sym_to_id[ch] for ch in text if ch in self.sym_to_id]

    def decode(self, ids: Iterable[int]) -> str:
        if self.id_to_bytes:
            return self._decode_bytes(ids)
        out: List[str] = []
        for i in ids:
            sym = self.id_to_sym.get(int(i), "")
            if not sym or sym in BLANK_TOKENS or sym == "<unk>":
                continue
            if sym.startswith(SPECIAL_PREFIX) and sym.endswith("|>"):
                continue  # SenseVoice language/itn/event prompt tokens
            if sym.startswith("▁"):
                out.append(" " + sym[1:])
            elif sym.startswith("@@"):
                out.append(sym[2:])
            else:
                out.append(sym)
        return "".join(out).strip()

    def _decode_bytes(self, ids: Iterable[int]) -> str:
        """Whisper byte-BPE: assemble the byte buffer across tokens, then
        UTF-8-decode once — multi-byte characters may be split across ids."""
        buf = bytearray()
        for i in ids:
            raw = self.id_to_bytes.get(int(i))
            if raw is not None:
                buf.extend(raw)
            # ids mapped only to a literal symbol are specials
            # (<|endoftext|>, timestamps...): dropped
        return buf.decode("utf-8", errors="replace").strip()
