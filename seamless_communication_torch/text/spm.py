"""Self-contained SentencePiece-compatible tokenizer (a copy of the Python
path of ``seamless_communication_tpu/text/spm.py``):

  - a minimal protobuf wire-format reader for ``sentencepiece.ModelProto``
    (.model files): field 1 = repeated SentencePiece{piece:1, score:2, type:3}
  - unigram-LM segmentation by Viterbi over piece scores, with byte fallback
    for unknown characters when the model defines <0xNN> pieces
  - encode/decode with NLLB's normalization: whitespace -> U+2581 '▁',
    dummy prefix, NFKC.

``build_spm_model`` serializes a toy ModelProto (tests and smoke runs).
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Iterable, List, Optional, Sequence

SPM_SPACE = "▁"

# SentencePiece piece types
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _write_field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint((field << 3) | wire) + payload


def build_spm_model(pieces: Sequence[tuple[str, float, int]]) -> bytes:
    """Serialize a ModelProto with the given (piece, score, type) triples."""
    out = bytearray()
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        body = (_write_field(1, 2, _write_varint(len(pb)) + pb)
                + _write_field(2, 5, struct.pack("<f", score))
                + _write_field(3, 0, _write_varint(ptype)))
        out += _write_field(1, 2, _write_varint(len(body)) + body)
    return bytes(out)


class SentencePieceModel:
    """Unigram/char SentencePiece model with Viterbi segmentation."""

    def __init__(self, pieces: Sequence[tuple[str, float, int]], *,
                 add_dummy_prefix: bool = True):
        self.pieces: List[str] = [p for p, _, _ in pieces]
        self.scores: List[float] = [s for _, s, _ in pieces]
        self.types: List[int] = [t for _, _, t in pieces]
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self.add_dummy_prefix = add_dummy_prefix
        self.unk_id = next((i for i, t in enumerate(self.types) if t == TYPE_UNKNOWN), 0)
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)
        self._byte_ids = {int(p[1:-1], 16): i
                          for i, (p, t) in enumerate(zip(self.pieces, self.types))
                          if t == TYPE_BYTE}
        # control/unused pieces never match raw text
        self._matchable = [t in (TYPE_NORMAL, TYPE_USER_DEFINED) for t in self.types]

    @classmethod
    def from_file(cls, path: str, **kw) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read(), **kw)

    @classmethod
    def from_bytes(cls, blob: bytes, **kw) -> "SentencePieceModel":
        pieces = []
        for field, wire, val in _iter_fields(blob):
            if field == 1 and wire == 2:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, TYPE_NORMAL
                for f2, _, v2 in _iter_fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                pieces.append((piece, score, ptype))
        return cls(pieces, **kw)

    def __len__(self) -> int:
        return len(self.pieces)

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # collapse whitespace
        if self.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", SPM_SPACE)

    def encode_as_pieces(self, text: str) -> List[str]:
        return [self.pieces[i] for i in self.encode(text)]

    def encode(self, text: str) -> List[int]:
        """Viterbi best segmentation by summed piece scores (unigram LM)."""
        s = self._normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[tuple[int, int]]] = [None] * (n + 1)  # (start, piece_id)
        best[0] = 0.0
        unk_score = min(self.scores, default=0.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            matched = False
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is None or not self._matchable[pid]:
                    continue
                sc = best[i] + self.scores[pid]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, pid)
                if j == i + 1:
                    matched = True
            if not matched:
                # unknown single char: byte fallback or <unk>
                sc = best[i] + unk_score
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, -1)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid == -1:
                bts = s[start:pos].encode("utf-8")
                if self._byte_ids:
                    ids.extend(self._byte_ids.get(b, self.unk_id) for b in reversed(bts))
                else:
                    ids.append(self.unk_id)
            else:
                ids.append(pid)
            pos = start
        ids.reverse()
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush_bytes():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if i < 0 or i >= len(self.pieces):
                continue
            t = self.types[i]
            if t == TYPE_BYTE:
                byte_buf.append(int(self.pieces[i][1:-1], 16))
                continue
            flush_bytes()
            if t in (TYPE_CONTROL, TYPE_UNUSED):
                continue
            out.append(" ⁇ " if t == TYPE_UNKNOWN else self.pieces[i])
        flush_bytes()
        return "".join(out).replace(SPM_SPACE, " ").lstrip(" ")

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i]

    def piece_to_id_or_unk(self, p: str) -> int:
        return self.piece_to_id.get(p, self.unk_id)
