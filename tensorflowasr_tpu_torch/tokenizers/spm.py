"""Pure-Python SentencePiece ``.model`` (ModelProto) codec + segmenters
(a copy of ``tensorflowasr_tpu/tokenizers/spm.py``).

Parses the protobuf wire format of a trained SentencePiece model directly
(pieces, scores, piece types, trainer/normalizer specs) — no ``sentencepiece``
or ``protobuf`` dependency — and implements both inference algorithms:

- **unigram**: Viterbi segmentation maximizing the sum of piece log-probs,
  with SentencePiece's unk penalty (min_score − 10) and consecutive-unknown
  fusing (``unigram_model.cc`` semantics).
- **bpe**: iterative highest-score merge of adjacent symbol pairs; scores in
  the model are −merge_rank so the highest score is the earliest-learned
  merge; ties break leftmost (``bpe_model.cc`` semantics).

Reference parity: the reference loads real ``.model`` files with
``tft.FastSentencepieceTokenizer`` (tensorflow_asr/tokenizers.py:267-277);
its published vocabularies (examples/datasets/*/sentencepiece/*.model) load
here unmodified, so published-checkpoint token IDs line up.

A serializer is also provided so vocabularies trained in this framework are
written as real ``.model`` protobufs readable by stock sentencepiece.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional

NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

UNIGRAM = 1
BPE = 2

_WHITESPACE = "▁"  # ▁
_UNK_PENALTY = 10.0


# ---------------------------------------------------------------- wire format


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    x, s = 0, 0
    while True:
        b = data[i]
        i += 1
        x |= (b & 0x7F) << s
        if not b & 0x80:
            return x, i
        s += 7


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) for one message's bytes."""
    i = 0
    n = len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _read_varint(data, i)
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            v = data[i : i + ln]
            i += ln
        elif wt == 5:  # fixed32
            v = data[i : i + 4]
            i += 4
        elif wt == 1:  # fixed64
            v = data[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fn, wt, v


def _write_varint(out: bytearray, x: int) -> None:
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_tag(out: bytearray, fn: int, wt: int) -> None:
    _write_varint(out, (fn << 3) | wt)


def _write_bytes_field(out: bytearray, fn: int, data: bytes) -> None:
    _write_tag(out, fn, 2)
    _write_varint(out, len(data))
    out.extend(data)


# ----------------------------------------------------------------- the model


@dataclass
class SentencePieceModel:
    pieces: list[str]
    scores: list[float]
    types: list[int]
    model_type: int = UNIGRAM
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    unk_id: int = 0
    unk_surface: str = " ⁇ "  # sentencepiece default; reference trains with ""
    normalizer_name: str = "nmt_nfkc"
    # derived
    _index: dict = field(default_factory=dict, repr=False)
    _max_piece_chars: int = field(default=0, repr=False)
    _byte_pieces: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t in (NORMAL, USER_DEFINED):
                self._index[p] = i
                self._max_piece_chars = max(self._max_piece_chars, len(p))
            elif t == BYTE:
                # pieces look like "<0x41>"
                self._byte_pieces[int(p[1:-1], 16)] = i
        if self.types and self.types[self.unk_id] != UNKNOWN:
            for i, t in enumerate(self.types):
                if t == UNKNOWN:
                    self.unk_id = i
                    break

    # -- construction -------------------------------------------------------

    @classmethod
    def parse(cls, data: bytes) -> "SentencePieceModel":
        pieces: list[str] = []
        scores: list[float] = []
        types: list[int] = []
        model_type = UNIGRAM
        add_dummy_prefix = True
        remove_extra_whitespaces = True
        escape_whitespaces = True
        unk_id = 0
        unk_surface = " ⁇ "
        normalizer_name = "nmt_nfkc"
        for fn, _wt, v in _iter_fields(data):
            if fn == 1:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for sfn, swt, sv in _iter_fields(v):
                    if sfn == 1:
                        piece = sv.decode("utf-8")
                    elif sfn == 2:
                        score = struct.unpack("<f", sv)[0]
                    elif sfn == 3:
                        ptype = sv
                pieces.append(piece)
                scores.append(score)
                types.append(ptype)
            elif fn == 2:  # TrainerSpec
                for sfn, swt, sv in _iter_fields(v):
                    if sfn == 3:  # model_type
                        model_type = sv
                    elif sfn == 40:  # unk_id
                        unk_id = sv
                    elif sfn == 44:  # unk_surface
                        unk_surface = sv.decode("utf-8")
            elif fn == 3:  # NormalizerSpec
                for sfn, swt, sv in _iter_fields(v):
                    if sfn == 1:
                        normalizer_name = sv.decode("utf-8")
                    elif sfn == 3:
                        add_dummy_prefix = bool(sv)
                    elif sfn == 4:
                        remove_extra_whitespaces = bool(sv)
                    elif sfn == 5:
                        escape_whitespaces = bool(sv)
        return cls(
            pieces=pieces,
            scores=scores,
            types=types,
            model_type=model_type,
            add_dummy_prefix=add_dummy_prefix,
            remove_extra_whitespaces=remove_extra_whitespaces,
            escape_whitespaces=escape_whitespaces,
            unk_id=unk_id,
            unk_surface=unk_surface,
            normalizer_name=normalizer_name,
        )

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.parse(f.read())

    def serialize(self) -> bytes:
        out = bytearray()
        for piece, score, ptype in zip(self.pieces, self.scores, self.types):
            sp = bytearray()
            _write_bytes_field(sp, 1, piece.encode("utf-8"))
            _write_tag(sp, 2, 5)
            sp.extend(struct.pack("<f", score))
            if ptype != NORMAL:
                _write_tag(sp, 3, 0)
                _write_varint(sp, ptype)
            _write_bytes_field(out, 1, bytes(sp))
        ts = bytearray()
        _write_tag(ts, 3, 0)
        _write_varint(ts, self.model_type)
        _write_tag(ts, 4, 0)
        _write_varint(ts, len(self.pieces))
        _write_tag(ts, 40, 0)
        _write_varint(ts, self.unk_id)
        _write_bytes_field(ts, 44, self.unk_surface.encode("utf-8"))
        _write_bytes_field(out, 2, bytes(ts))
        ns = bytearray()
        _write_bytes_field(ns, 1, self.normalizer_name.encode("utf-8"))
        _write_tag(ns, 3, 0)
        _write_varint(ns, int(self.add_dummy_prefix))
        _write_tag(ns, 4, 0)
        _write_varint(ns, int(self.remove_extra_whitespaces))
        _write_tag(ns, 5, 0)
        _write_varint(ns, int(self.escape_whitespaces))
        _write_bytes_field(out, 3, bytes(ns))
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    # -- encoding ------------------------------------------------------------

    def _preprocess(self, text: str) -> str:
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if not text:
            return ""
        if self.add_dummy_prefix:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", _WHITESPACE)
        return text

    def encode(self, text: str) -> list[int]:
        text = self._preprocess(text)
        if not text:
            return []
        if self.model_type == BPE:
            ids = self._encode_bpe(text)
        else:
            ids = self._encode_unigram(text)
        return ids

    def _unknown_ids(self, surface: str) -> list[int]:
        """Unknown surface → byte-fallback pieces when present, else unk_id."""
        if self._byte_pieces:
            return [self._byte_pieces.get(b, self.unk_id) for b in surface.encode("utf-8")]
        return [self.unk_id]

    def _encode_unigram(self, text: str) -> list[int]:
        n = len(text)
        index = self._index
        maxlen = self._max_piece_chars
        scores = self.scores
        min_score = min((scores[i] for p, i in index.items()), default=0.0)
        unk_score = min_score - _UNK_PENALTY
        NEG = -1e18
        # best[i]: best score of a segmentation of text[:i]; back[i] = (start, piece_id)
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: list[Optional[tuple[int, int]]] = [None] * (n + 1)
        for i in range(n):
            bi = best[i]
            if bi <= NEG:
                continue
            matched_single = False
            for ln in range(1, min(maxlen, n - i) + 1):
                pid = index.get(text[i : i + ln])
                if pid is None:
                    continue
                if ln == 1:
                    matched_single = True
                s = bi + scores[pid]
                if s > best[i + ln]:
                    best[i + ln] = s
                    back[i + ln] = (i, pid)
            if not matched_single:
                s = bi + unk_score
                if s > best[i + 1]:
                    best[i + 1] = s
                    back[i + 1] = (i, -1)  # unk over one char
        # walk back
        out: list[tuple[int, str]] = []  # (piece_id or -1, surface)
        i = n
        while i > 0:
            start, pid = back[i]
            out.append((pid, text[start:i]))
            i = start
        out.reverse()
        # fuse consecutive unknowns into one piece (sentencepiece semantics)
        ids: list[int] = []
        pending_unk = ""
        for pid, surf in out:
            if pid == -1:
                pending_unk += surf
                continue
            if pending_unk:
                ids.extend(self._unknown_ids(pending_unk))
                pending_unk = ""
            ids.append(pid)
        if pending_unk:
            ids.extend(self._unknown_ids(pending_unk))
        return ids

    def _encode_bpe(self, text: str) -> list[int]:
        import heapq

        chars = list(text)
        n = len(chars)
        # symbol linked list
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        sym = chars[:]  # surface of each live symbol
        alive = [True] * n
        index = self._index
        scores = self.scores

        heap: list[tuple[float, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j < 0:
                return
            merged = sym[i] + sym[j]
            pid = index.get(merged)
            if pid is not None:
                heapq.heappush(heap, (-scores[pid], i, merged))

        for i in range(n - 1):
            push(i)
        while heap:
            negscore, i, merged = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j < 0 or not alive[j] or sym[i] + sym[j] != merged:
                continue
            # merge j into i
            sym[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                push(prv[i])
            push(i)
        ids: list[int] = []
        i = 0
        while i >= 0:
            if alive[i]:
                pid = index.get(sym[i])
                if pid is None:
                    ids.extend(self._unknown_ids(sym[i]))
                else:
                    ids.append(pid)
            i = nxt[i]
        return ids

    # -- decoding ------------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        parts: list[str] = []
        byte_buf = bytearray()

        def flush_bytes():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.pieces):
                continue
            t = self.types[i]
            if t == BYTE:
                byte_buf.append(int(self.pieces[i][1:-1], 16))
                continue
            flush_bytes()
            if t == UNKNOWN:
                parts.append(self.unk_surface)
            elif t in (NORMAL, USER_DEFINED):
                parts.append(self.pieces[i])
            # CONTROL / UNUSED pieces produce nothing
        flush_bytes()
        text = "".join(parts)
        if self.escape_whitespaces:
            text = text.replace(_WHITESPACE, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text
