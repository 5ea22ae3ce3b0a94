"""zstd decompression (RFC 8878): the native decoder (``zstd_decoder.cc``,
built with ``g++`` at first use and bound with ``ctypes``) and its plain
pure-Python version.

:func:`zstd_decode` is what the checkpoint reader (``convert/orbax.py``)
calls. Its library is built and loaded by ``native.load``, as the FLAC
decoder's is: into ``tensorflowasr_tpu_torch/_build/`` under a name keyed
on the source's hash; a failed build or load raises, and nothing falls
back to the plain version. Nothing is built at import.

:func:`zstd_decode_python` decodes the same streams in Python, about a
thousand times slower; the tests hold the native decoder against it and it
is used by nothing else.

Both decode one or more concatenated frames and skip skippable frames;
read frame headers with or without the content size; raw, RLE and
compressed blocks; raw, RLE and Huffman-coded literals (one or four
streams, a new or a repeated table, weights direct or FSE-coded); the
sequences' predefined, RLE, FSE and repeat modes and the three repeat
offsets; and verify the XXH64 content checksum. A frame that names a
dictionary raises, as does any malformed input.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

from tensorflowasr_tpu_torch import native
from tensorflowasr_tpu_torch.ops.cuda import _build

SOURCE = Path(__file__).resolve().parent / "zstd_decoder.cc"

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    return _build.hashed_library("tfasr_zstd", (SOURCE,), native.CXX_FLAGS)


def lib() -> ctypes.CDLL:
    """The loaded library, built first if there is none for this source."""
    global _lib
    with _lock:
        if _lib is None:
            lib_ = native.load(library_path(), SOURCE, "zstd")
            lib_.tfasr_zstd_decode.restype = ctypes.c_void_p
            lib_.tfasr_zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_size_t]
            lib_.tfasr_zstd_free.restype = None
            lib_.tfasr_zstd_free.argtypes = [ctypes.c_void_p]
            _lib = lib_
        return _lib


def zstd_decode(data: bytes) -> bytes:
    """Decompresses every frame of ``data`` with the native decoder; raises ``ValueError`` on input it cannot decode."""
    lib_ = lib()
    data = bytes(data)
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    ptr = lib_.tfasr_zstd_decode(data, len(data), ctypes.byref(n), err, len(err))
    if not ptr:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib_.tfasr_zstd_free(ptr)


# ----------------------------------------------------------------------------
# The plain version.

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50  # ... 0x184D2A5F
BLOCK_MAX = 1 << 17

LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (largest accuracy log, largest symbol) of the literal-length, offset and match-length codes
LIMITS = {"ll": (9, 35), "of": (8, 31), "ml": (9, 52)}

M64 = (1 << 64) - 1
P1, P2, P3, P4, P5 = 11400714785074694791, 14029467366897019727, 1609587929392839161, 9650029242287828579, 2870177450012600261


def _corrupt(what: str) -> ValueError:
    return ValueError(f"zstd: {what}")


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * P2) & M64, 31) * P1) & M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum is its low 32 bits)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + P1 + P2) & M64, (seed + P2) & M64, seed & M64, (seed - P1) & M64]
        stripes = n // 32
        for a, b, c, d in struct.iter_unpack("<4Q", data[: stripes * 32]):
            v = [_round(v[0], a), _round(v[1], b), _round(v[2], c), _round(v[3], d)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & M64
        for lane in v:
            h = ((h ^ _round(0, lane)) * P1 + P4) & M64
        p = stripes * 32
    else:
        h = (seed + P5) & M64
    h = (h + n) & M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, struct.unpack_from("<Q", data, p)[0]), 27) * P1 + P4) & M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ ((struct.unpack_from("<I", data, p)[0] * P1) & M64), 23) * P2 + P3) & M64
        p += 4
    while p < n:
        h = (_rotl(h ^ ((data[p] * P5) & M64), 11) * P1) & M64
        p += 1
    h = ((h ^ (h >> 33)) * P2) & M64
    h = ((h ^ (h >> 29)) * P3) & M64
    return h ^ (h >> 32)


class _BackwardBits:
    """A backward bitstream: read from its last bit down, after the end marker
    (the highest set bit of the last byte). Reads past the start yield zeros
    and leave :attr:`pos` negative."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise _corrupt("bitstream without its end marker")
        self.buf = buf
        self.pos = (len(buf) - 1) * 8 + buf[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            return (int.from_bytes(self.buf[p >> 3 : (p + n + 7) >> 3], "little") >> (p & 7)) & ((1 << n) - 1)
        if p + n <= 0:
            return 0
        return (int.from_bytes(self.buf[: (p + n + 7) >> 3], "little") << -p) & ((1 << n) - 1)


def _read_fse_description(buf: bytes, start: int, max_log: int, max_symbol: int) -> tuple[list[int], int, int]:
    """An FSE table description at ``buf[start:]``: (normalized counts, accuracy log, bytes used)."""
    bit = start * 8

    def peek(n: int) -> int:
        return (int.from_bytes(buf[bit >> 3 : (bit + n + 7) >> 3], "little") >> (bit & 7)) & ((1 << n) - 1)

    if start >= len(buf):
        raise _corrupt("truncated FSE table description")
    log = peek(4) + 5
    bit += 4
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    norm: list[int] = []
    previous0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if previous0:
            while True:
                repeat = peek(2)
                bit += 2
                norm.extend([0] * repeat)
                if repeat != 3:
                    break
            if len(norm) > max_symbol:
                raise _corrupt("FSE table description past the largest symbol")
        most = (2 * threshold - 1) - remaining
        bits = peek(nbits)
        if (bits & (threshold - 1)) < most:
            value = bits & (threshold - 1)
            bit += nbits - 1
        else:
            value = bits & (2 * threshold - 1)
            if value >= threshold:
                value -= most
            bit += nbits
        count = value - 1
        remaining -= abs(count)
        norm.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    used = (bit - start * 8 + 7) // 8
    if remaining != 1 or start + used > len(buf):
        raise _corrupt("malformed FSE table description")
    return norm, log, used


def _fse_table(norm: list[int], log: int) -> tuple[list[int], list[int], list[int], int]:
    """The decoding table of a distribution: (symbol, bits, baseline) per state, and the accuracy log."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _corrupt("FSE distribution does not fill its table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[symbol[u]]
        nxt[symbol[u]] += 1
        nbits[u] = log - (x.bit_length() - 1)
        base[u] = (x << nbits[u]) - size
    return symbol, nbits, base, log


def _huffman_table(weights: list[int]) -> tuple[list[int], list[int], int]:
    """The decoding table of Huffman weights (the last symbol's weight implied): (symbol, bits) per index, max bits."""
    if len(weights) > 255 or any(w > 11 for w in weights):
        raise _corrupt("malformed Huffman weights")
    total = sum((1 << w) >> 1 for w in weights)
    if total == 0:
        raise _corrupt("Huffman weights all zero")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1) or max_bits > 11:
        raise _corrupt("Huffman weights do not sum to a power of two")
    weights = weights + [left.bit_length()]
    bits = [max_bits + 1 - w if w else 0 for w in weights]
    count = [0] * (max_bits + 1)
    for b in bits:
        if b:
            count[b] += 1
    start = [0] * (max_bits + 2)
    for b in range(max_bits, 0, -1):
        start[b - 1] = start[b] + count[b] * (1 << (max_bits - b))
    size = 1 << max_bits
    symbol, nbits = [0] * size, [0] * size
    for s, b in enumerate(bits):
        if b:
            n = 1 << (max_bits - b)
            symbol[start[b] : start[b] + n] = [s] * n
            nbits[start[b] : start[b] + n] = [b] * n
            start[b] += n
    return symbol, nbits, max_bits


def _huffman_description(data: bytes) -> tuple[tuple, int]:
    """A Huffman tree description at the start of ``data``: (table, bytes used)."""
    if not data:
        raise _corrupt("truncated Huffman tree description")
    head = data[0]
    if head >= 128:
        n = head - 127
        used = 1 + (n + 1) // 2
        if used > len(data):
            raise _corrupt("truncated Huffman weights")
        weights = [(data[1 + i // 2] >> 4) if i % 2 == 0 else (data[1 + i // 2] & 15) for i in range(n)]
        return _huffman_table(weights), used
    used = 1 + head
    if used > len(data) or head == 0:
        raise _corrupt("truncated FSE-coded Huffman weights")
    body = data[1:used]
    norm, log, n = _read_fse_description(body, 0, 6, 255)
    symbol, nbits, base, _ = _fse_table(norm, log)
    bits = _BackwardBits(body[n:])
    s1, s2 = bits.read(log), bits.read(log)
    weights: list[int] = []
    while True:
        weights.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            weights.append(symbol[s1])
            break
        if len(weights) > 255:
            raise _corrupt("too many Huffman weights")
    return _huffman_table(weights), used


def _huffman_stream(data: bytes, n: int, table: tuple) -> bytes:
    symbol, nbits, max_bits = table
    bits = _BackwardBits(data)
    mask = (1 << max_bits) - 1
    state = bits.read(max_bits)
    out = bytearray(n)
    for i in range(n):
        out[i] = symbol[state]
        b = nbits[state]
        state = ((state << b) & mask) | bits.read(b)
    if bits.pos != -max_bits:
        raise _corrupt("Huffman stream not consumed exactly")
    return bytes(out)


class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(block: bytes, pos: int, st: _FrameState) -> tuple[bytes, int]:
    if pos >= len(block):
        raise _corrupt("truncated literals section")
    b0 = block[pos]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if size_format in (0, 2):
            regen, head = b0 >> 3, 1
        elif size_format == 1:
            regen, head = (b0 >> 4) + (block[pos + 1] << 4), 2
        else:
            regen, head = (b0 >> 4) + (block[pos + 1] << 4) + (block[pos + 2] << 12), 3
        pos += head
        if kind == 0:
            if pos + regen > len(block):
                raise _corrupt("truncated raw literals")
            return block[pos : pos + regen], pos + regen
        if pos >= len(block):
            raise _corrupt("truncated RLE literals")
        return bytes([block[pos]]) * regen, pos + 1
    streams, head, width = {0: (1, 3, 10), 1: (4, 3, 10), 2: (4, 4, 14), 3: (4, 5, 18)}[size_format]
    if pos + head > len(block):
        raise _corrupt("truncated literals header")
    h = int.from_bytes(block[pos : pos + head], "little")
    regen, comp = (h >> 4) & ((1 << width) - 1), (h >> (4 + width)) & ((1 << width) - 1)
    pos += head
    if pos + comp > len(block) or regen > BLOCK_MAX:
        raise _corrupt("truncated Huffman literals")
    data = block[pos : pos + comp]
    pos += comp
    if kind == 2:
        st.huffman, used = _huffman_description(data)
        data = data[used:]
    elif st.huffman is None:
        raise _corrupt("treeless literals without an earlier Huffman table")
    if streams == 1:
        return _huffman_stream(data, regen, st.huffman), pos
    if len(data) < 6:
        raise _corrupt("truncated jump table")
    s1, s2, s3 = struct.unpack_from("<3H", data, 0)
    s4 = len(data) - 6 - s1 - s2 - s3
    if s4 < 0:
        raise _corrupt("jump table past the literals")
    each = (regen + 3) // 4
    if regen < 3 * each:
        raise _corrupt("literals too short for four streams")
    out, at = [], 6
    for size, n in zip((s1, s2, s3, s4), (each, each, each, regen - 3 * each)):
        out.append(_huffman_stream(data[at : at + size], n, st.huffman))
        at += size
    return b"".join(out), pos


def _sequence_table(kind: str, mode: int, block: bytes, pos: int, st: _FrameState) -> tuple[tuple, int]:
    max_log, max_symbol = LIMITS[kind]
    if mode == 0:
        norm, log = {"ll": LL_DEFAULT, "of": OF_DEFAULT, "ml": ML_DEFAULT}[kind]
        table = _fse_table(norm, log)
    elif mode == 1:
        if pos >= len(block) or block[pos] > max_symbol:
            raise _corrupt("bad RLE sequence symbol")
        table = ([block[pos]], [0], [0], 0)
        pos += 1
    elif mode == 2:
        norm, log, used = _read_fse_description(block, pos, max_log, max_symbol)
        table = _fse_table(norm, log)
        pos += used
    else:
        if st.tables[kind] is None:
            raise _corrupt("repeat mode without an earlier table")
        table = st.tables[kind]
    st.tables[kind] = table
    return table, pos


def _sequences(block: bytes, pos: int, st: _FrameState) -> list[tuple[int, int, int]]:
    if pos >= len(block):
        raise _corrupt("truncated sequences section")
    n = block[pos]
    pos += 1
    if n == 0:
        if pos != len(block):
            raise _corrupt("bytes after an empty sequences section")
        return []
    if n >= 128:
        if n < 255:
            n, pos = ((n - 128) << 8) + block[pos], pos + 1
        else:
            n, pos = block[pos] + (block[pos + 1] << 8) + 0x7F00, pos + 2
    if pos >= len(block):
        raise _corrupt("truncated sequences header")
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise _corrupt("reserved bits set in the sequence modes")
    ll, pos = _sequence_table("ll", modes >> 6, block, pos, st)
    of, pos = _sequence_table("of", (modes >> 4) & 3, block, pos, st)
    ml, pos = _sequence_table("ml", (modes >> 2) & 3, block, pos, st)
    bits = _BackwardBits(block[pos:])
    ll_s, of_s, ml_s = bits.read(ll[3]), bits.read(of[3]), bits.read(ml[3])
    rep = st.rep
    out = []
    for i in range(n):
        of_code, ll_code, ml_code = of[0][of_s], ll[0][ll_s], ml[0][ml_s]
        value = (1 << of_code) + bits.read(of_code)
        match = ML_BASE[ml_code] + bits.read(ML_BITS[ml_code])
        lit = LL_BASE[ll_code] + bits.read(LL_BITS[ll_code])
        if value > 3:
            offset = value - 3
            rep = [offset, rep[0], rep[1]]
        else:
            idx = value - 1 + (lit == 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if offset == 0:
                    raise _corrupt("repeat offset of zero")
                rep = [offset, rep[0], rep[2]] if idx == 1 else [offset, rep[0], rep[1]]
        out.append((lit, offset, match))
        if i != n - 1:
            ll_s = ll[2][ll_s] + bits.read(ll[1][ll_s])
            ml_s = ml[2][ml_s] + bits.read(ml[1][ml_s])
            of_s = of[2][of_s] + bits.read(of[1][of_s])
    if bits.pos != 0:
        raise _corrupt("sequence bitstream not consumed exactly")
    st.rep = rep
    return out


def _compressed_block(block: bytes, out: bytearray, st: _FrameState) -> None:
    lits, pos = _literals(block, 0, st)
    at = 0
    start = len(out)
    for lit, offset, match in _sequences(block, pos, st):
        if at + lit > len(lits):
            raise _corrupt("sequence past the literals")
        out += lits[at : at + lit]
        at += lit
        if offset > len(out):
            raise _corrupt("match offset before the start of the frame")
        src = len(out) - offset
        if offset >= match:
            out += out[src : src + match]
        else:
            piece = bytes(out[src:])
            out += (piece * (match // offset + 1))[:match]
    out += lits[at:]
    if len(out) - start > BLOCK_MAX:
        raise _corrupt("block larger than 128 KiB")


def _frame(data: bytes, pos: int) -> tuple[bytes, int]:
    if pos + 6 > len(data):
        raise _corrupt("truncated frame header")
    fhd = data[pos + 4]
    pos += 5
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise _corrupt("reserved bit set in the frame header")
    if not single:
        wd = data[pos]
        pos += 1
        if (wd >> 3) > 21:
            raise _corrupt("window larger than 2 GiB")
    dict_bytes = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[pos : pos + dict_bytes], "little")
    pos += dict_bytes
    if dict_id:
        raise ValueError(f"zstd: frame needs dictionary {dict_id}, and no dictionary is supported")
    fcs_bytes = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_bytes > len(data):
        raise _corrupt("truncated frame header")
    size = int.from_bytes(data[pos : pos + fcs_bytes], "little") + (256 if fcs_bytes == 2 else 0) if fcs_bytes else None
    pos += fcs_bytes
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise _corrupt("truncated block header")
        head = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
        if kind == 3:
            raise _corrupt("reserved block type")
        if bsize > BLOCK_MAX:
            raise _corrupt("block larger than 128 KiB")
        if kind == 1:
            if pos >= len(data):
                raise _corrupt("truncated RLE block")
            out += bytes([data[pos]]) * bsize
            pos += 1
        else:
            if pos + bsize > len(data):
                raise _corrupt("truncated block")
            if kind == 0:
                out += data[pos : pos + bsize]
            else:
                _compressed_block(data[pos : pos + bsize], out, st)
            pos += bsize
        if size is not None and len(out) > size:
            raise _corrupt("frame longer than its content size")
        if last:
            break
    if size is not None and len(out) != size:
        raise _corrupt("frame content size mismatch")
    if checksum:
        if pos + 4 > len(data):
            raise _corrupt("truncated content checksum")
        if struct.unpack_from("<I", data, pos)[0] != xxh64(bytes(out)) & 0xFFFFFFFF:
            raise _corrupt("content checksum mismatch")
        pos += 4
    return bytes(out), pos


def zstd_decode_python(data: bytes) -> bytes:
    """The plain version of :func:`zstd_decode`: every frame of ``data``, decoded in Python."""
    data = bytes(data)
    if not data:
        raise _corrupt("empty input")
    pos, parts = 0, []
    while pos < len(data):
        if pos + 4 > len(data):
            raise _corrupt("truncated frame magic")
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic & 0xFFFFFFF0 == SKIPPABLE_MAGIC:
            if pos + 8 > len(data):
                raise _corrupt("truncated skippable frame")
            pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
            if pos > len(data):
                raise _corrupt("truncated skippable frame")
            continue
        if magic != FRAME_MAGIC:
            raise _corrupt(f"bad frame magic 0x{magic:08x}")
        out, pos = _frame(data, pos)
        parts.append(out)
    return b"".join(parts)
