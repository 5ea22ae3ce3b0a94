"""Audio IO: WAV and FLAC codecs and resampling (counterpart of
``tensorflowasr_tpu/data/audio.py``).

- WAV: PCM 8/16/24/32 and float32, read and write (numpy);
- FLAC: :func:`read_flac` decodes with the native decoder
  (``native/flac_decoder.cc``, built with g++ at first use; a failed build
  raises); :func:`read_flac_python` is the pure-Python decoder (constant,
  verbatim, fixed and LPC subframes, rice/rice2 residuals, every channel
  assignment), kept as the plain version; :func:`write_flac` is a
  fixed-prediction encoder for tests and dataset tooling;
- resampling by polyphase filtering (scipy).

:func:`read_audio` returns float32 in [-1, 1], mono (the channels'
mean), at the requested rate.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

# ----------------------------------- WAV ------------------------------------ #


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (float32 samples [-1,1], shape [N] mono or [N, C]), rate."""
    with open(path, "rb") as f:
        data = f.read()
    return _parse_wav(data, path)


def _parse_wav(data: bytes, path: str = "<bytes>") -> tuple[np.ndarray, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file: {path}")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            audio_format, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            fmt = (audio_format, channels, rate, bits)
        elif cid == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, channels, rate, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(samples, "<f4").astype(np.float32)
    elif audio_format in (1, 0xFFFE):
        if bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(samples, np.uint8).reshape(-1, 3)
            vals = raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8) | (raw[:, 2].astype(np.int32) << 16)
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bits: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")
    if channels > 1:
        x = x[: len(x) // channels * channels].reshape(-1, channels)
    return x, rate


def wav_bytes(samples: np.ndarray, rate: int) -> bytes:
    """Encode float32 [-1,1] (mono [N] or [N,C]) as PCM16 WAV bytes."""
    x = np.asarray(samples)
    channels = 1 if x.ndim == 1 else x.shape[1]
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2").tobytes()
    byte_rate = rate * channels * 2
    header = (
        b"RIFF"
        + struct.pack("<I", 36 + len(pcm))
        + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, channels, rate, byte_rate, channels * 2, 16)
        + b"data"
        + struct.pack("<I", len(pcm))
    )
    return header + pcm


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode WAV bytes (see read_wav)."""
    return _parse_wav(data)


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Write float32 [-1,1] (mono [N] or [N,C]) as PCM16 WAV."""
    with open(path, "wb") as f:
        f.write(wav_bytes(samples, rate))


# ----------------------------------- FLAC ----------------------------------- #


class _BitReader:
    """MSB-first bit reader over bytes."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.pos = bitpos  # bit position

    def read(self, nbits: int) -> int:
        p = self.pos
        self.pos = p + nbits
        start_byte = p >> 3
        end_byte = (p + nbits + 7) >> 3
        chunk = int.from_bytes(self.data[start_byte:end_byte], "big")
        total_bits = (end_byte - start_byte) * 8
        chunk >>= total_bits - (p - (start_byte << 3)) - nbits if False else (total_bits - ((p & 7) + nbits))
        return chunk & ((1 << nbits) - 1)

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v >= 1 << (nbits - 1):
            v -= 1 << nbits
        return v

    def read_unary(self) -> int:
        """Count zero bits until the next set bit (consumes it)."""
        data = self.data
        p = self.pos
        count = 0
        # fast byte-wise scan
        while True:
            byte = data[p >> 3]
            rem = 8 - (p & 7)
            window = byte & ((1 << rem) - 1)
            if window == 0:
                count += rem
                p += rem
            else:
                lead = rem - window.bit_length()
                count += lead
                p += lead + 1
                self.pos = p
                return count

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7


def _read_utf8_coded(br: _BitReader) -> int:
    """FLAC frame/sample number: UTF-8-style variable length code."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n):
        val = (val << 6) | (br.read(8) & 0x3F)
    return val


_FLAC_BLOCK_SIZES = [0, 192, 576, 1152, 2304, 4608, -1, -2, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_FLAC_SAMPLE_RATES = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000, 32000, 44100, 48000, 96000, -1, -2, -3, 0]
_FLAC_SAMPLE_SIZES = [0, 8, 12, 0, 16, 20, 24, 32]


@dataclass
class FlacStreamInfo:
    min_block: int
    max_block: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int


def _decode_residuals(br: _BitReader, order: int, block_size: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    nparts = 1 << part_order
    out = np.empty(block_size - order, np.int64)
    idx = 0
    for part in range(nparts):
        n = (block_size >> part_order) - (order if part == 0 else 0)
        k = br.read(plen)
        if k == escape:
            raw_bits = br.read(5)
            for i in range(n):
                out[idx] = br.read_signed(raw_bits) if raw_bits else 0
                idx += 1
        else:
            read_unary = br.read_unary
            read = br.read
            if k:
                for i in range(n):
                    q = read_unary()
                    v = (q << k) | read(k)
                    out[idx] = (v >> 1) ^ -(v & 1)
                    idx += 1
            else:
                for i in range(n):
                    v = read_unary()
                    out[idx] = (v >> 1) ^ -(v & 1)
                    idx += 1
    return out


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # constant
        v = br.read_signed(bps)
        out = np.full(block_size, v, np.int64)
    elif sf_type == 1:  # verbatim
        out = np.empty(block_size, np.int64)
        for i in range(block_size):
            out[i] = br.read_signed(bps)
    elif 8 <= sf_type <= 12:  # fixed
        order = sf_type - 8
        warmup = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residuals(br, order, block_size)
        out = np.empty(block_size, np.int64)
        out[:order] = warmup
        coefs = _FIXED_COEFS[order]
        if order == 0:
            out[:] = resid
        else:
            o = out
            for i in range(order, block_size):
                acc = 0
                for j, c in enumerate(coefs):
                    acc += c * o[i - 1 - j]
                o[i] = resid[i - order] + acc
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        warmup = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        resid = _decode_residuals(br, order, block_size)
        out = np.empty(block_size, np.int64)
        out[:order] = warmup
        o = out
        for i in range(order, block_size):
            acc = 0
            for j in range(order):
                acc += coefs[j] * o[i - 1 - j]
            o[i] = resid[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")

    if wasted:
        out <<= wasted
    return out


def read_flac_python(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file in Python → (float32 samples [N] mono or [N, C], rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError(f"not a FLAC file: {path}")
    pos = 4
    info: Optional[FlacStreamInfo] = None
    while True:
        header = data[pos : pos + 4]
        last = header[0] & 0x80
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            min_block = br.read(16)
            max_block = br.read(16)
            br.read(24)  # min frame size
            br.read(24)  # max frame size
            rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            info = FlacStreamInfo(min_block, max_block, rate, channels, bps, total)
        pos += 4 + length
        if last:
            break
    if info is None:
        raise ValueError("missing STREAMINFO")

    out = np.empty((info.total_samples or 0, info.channels), np.int64) if info.total_samples else None
    chunks = []
    written = 0
    br = _BitReader(data, pos * 8)
    total_bits = len(data) * 8
    while br.pos + 16 <= total_bits:
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise ValueError(f"lost frame sync at bit {br.pos - 14}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_coded(br)
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _FLAC_BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        bps = _FLAC_SAMPLE_SIZES[ss_code] or info.bits_per_sample
        br.read(8)  # CRC-8

        if ch_code < 8:
            nch = ch_code + 1
            subframes = [_decode_subframe(br, block_size, bps) for _ in range(nch)]
            frame = np.stack(subframes, axis=1)
        else:
            # stereo decorrelation: side channel carries one extra bit
            if ch_code == 8:  # left/side
                left = _decode_subframe(br, block_size, bps)
                side = _decode_subframe(br, block_size, bps + 1)
                frame = np.stack([left, left - side], axis=1)
            elif ch_code == 9:  # right/side
                side = _decode_subframe(br, block_size, bps + 1)
                right = _decode_subframe(br, block_size, bps)
                frame = np.stack([right + side, right], axis=1)
            elif ch_code == 10:  # mid/side
                mid = _decode_subframe(br, block_size, bps)
                side = _decode_subframe(br, block_size, bps + 1)
                left = ((mid << 1) | (side & 1)) + side
                frame = np.stack([left >> 1, (left >> 1) - side], axis=1)
            else:
                raise ValueError(f"reserved channel assignment {ch_code}")

        br.align_byte()
        br.read(16)  # CRC-16
        chunks.append(frame)
        written += block_size
        if info.total_samples and written >= info.total_samples:
            break

    pcm = np.concatenate(chunks, axis=0)
    if info.total_samples:
        pcm = pcm[: info.total_samples]
    scale = float(1 << (info.bits_per_sample - 1))
    x = (pcm.astype(np.float32) / scale).astype(np.float32)
    if info.channels == 1:
        x = x[:, 0]
    return x, info.sample_rate


# -------------------------------- FLAC encoder -------------------------------- #


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


_CRC8_TABLE = None
_CRC16_TABLE = None


def _crc8(data: bytes) -> int:
    global _CRC8_TABLE
    if _CRC8_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
            table.append(c)
        _CRC8_TABLE = table
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    global _CRC16_TABLE
    if _CRC16_TABLE is None:
        table = []
        for i in range(256):
            c = i << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
            table.append(c)
        _CRC16_TABLE = table
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]
    return crc


def _utf8_code(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 1
    while n >= (1 << (6 * nbytes + (6 - nbytes))):
        nbytes += 1
    lead_bits = 6 - nbytes
    lead = (0xFF << (lead_bits + 1)) & 0xFF | (n >> (6 * nbytes))
    out.append(lead)
    for i in range(nbytes - 1, -1, -1):
        out.append(0x80 | ((n >> (6 * i)) & 0x3F))
    return bytes(out)


def write_flac(path: str, samples: np.ndarray, rate: int, bits_per_sample: int = 16, block_size: int = 4096) -> None:
    """Encode float32 [-1,1] mono/stereo to FLAC using fixed-order prediction
    + rice residuals (validates the decoder's fixed/rice paths round-trip)."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    scale = 1 << (bits_per_sample - 1)
    pcm = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)

    out = bytearray()
    out += b"fLaC"
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(rate, 20)
    si.write(channels - 1, 3)
    si.write(bits_per_sample - 1, 5)
    si.write(n, 36)
    body = si.bytes() + b"\x00" * 16  # md5 zeroed
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    def encode_subframe(bw: _BitWriter, sig: np.ndarray, bps: int):
        # choose best fixed order by residual magnitude
        best_order, best_resid, best_cost = 0, sig, None
        d = sig
        for order in range(5):
            if order > 0:
                d = np.diff(d)
            resid = d if order == 0 else d
            cost = np.abs(resid[order:] if order == 0 else resid).sum()
            if len(sig) <= order:
                break
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best_order = order
                best_resid = resid
        order = best_order
        resid = np.diff(sig, n=order) if order else sig.copy()
        bw.write(0, 1)
        bw.write(8 + order, 6)
        bw.write(0, 1)  # no wasted bits
        for i in range(order):
            bw.write(int(sig[i]) & ((1 << bps) - 1), bps)
        # residual: method 0 (4-bit rice), partition order 0
        bw.write(0, 2)
        bw.write(0, 4)
        r = resid[order:] if order == 0 else resid
        if order == 0:
            r = resid
        zz = (np.abs(r) * 2 - (r < 0)).astype(np.int64)  # zigzag
        mean = max(int(zz.mean()) if len(zz) else 0, 1)
        k = min(max(mean.bit_length() - 1, 0), 14)
        bw.write(k, 4)
        for v in zz:
            q = int(v) >> k
            bw.write_unary(q)
            if k:
                bw.write(int(v) & ((1 << k) - 1), k)

    frame_idx = 0
    for start in range(0, n, block_size):
        blk = pcm[start : start + block_size]
        bs = len(blk)
        hdr = _BitWriter()
        hdr.write(0b11111111111110, 14)
        hdr.write(0, 1)
        hdr.write(0, 1)  # fixed blocksize strategy
        hdr.write(7, 4)  # block size: 16-bit at end of header
        hdr.write(0, 4)  # sample rate: from streaminfo
        hdr.write(channels - 1, 4)
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits_per_sample]
        hdr.write(ss_code, 3)
        hdr.write(0, 1)
        hdr.align()
        header_bytes = bytearray(hdr.bytes())
        header_bytes += _utf8_code(frame_idx)
        header_bytes += (bs - 1).to_bytes(2, "big")
        header_bytes.append(_crc8(bytes(header_bytes)))

        bw = _BitWriter()
        for ch in range(channels):
            encode_subframe(bw, blk[:, ch], bits_per_sample)
        bw.align()
        frame = bytes(header_bytes) + bw.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
        frame_idx += 1

    with open(path, "wb") as f:
        f.write(bytes(out))


# --------------------------------- dispatch ---------------------------------- #


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file with the native decoder → (float32 samples [N] mono or [N, C], rate)."""
    from tensorflowasr_tpu_torch import native

    return native.read_flac_native(path)


def read_audio(path: str, sample_rate: Optional[int] = None, mono: bool = True) -> np.ndarray:
    """Read WAV/FLAC → float32 [-1,1] (mono unless ``mono=False``) at
    ``sample_rate`` (resampled; None keeps the file's rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flac":
        x, rate = read_flac(path)
    elif ext in (".wav", ".wave"):
        x, rate = read_wav(path)
    else:
        raise ValueError(f"unsupported audio format: {path}")
    if mono and x.ndim > 1:
        x = x.mean(axis=1)
    if sample_rate is not None and rate != sample_rate:
        x = resample(x, rate, sample_rate)
    return np.asarray(x, np.float32)


def audio_duration(path: str) -> float:
    """Duration in seconds from the container header alone (no decode).

    FLAC: STREAMINFO total-samples / rate. WAV: data-chunk size / byte rate.
    Used by dataset-prep utilities that stamp durations for thousands of
    files.
    """
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
    if ext == ".flac":
        if head[:4] != b"fLaC":
            raise ValueError(f"not a FLAC file: {path}")
        pos = 4
        while pos + 4 <= len(head):
            last = head[pos] & 0x80
            btype = head[pos] & 0x7F
            length = int.from_bytes(head[pos + 1 : pos + 4], "big")
            if btype == 0:  # STREAMINFO
                br = _BitReader(head[pos + 4 : pos + 4 + length])
                br.read(16 + 16 + 24 + 24)
                rate = br.read(20)
                br.read(3 + 5)
                total = br.read(36)
                if rate == 0:
                    raise ValueError(f"invalid STREAMINFO rate in {path}")
                return total / rate
            pos += 4 + length
            if last:
                break
        raise ValueError(f"missing STREAMINFO in {path}")
    if ext in (".wav", ".wave"):
        x, rate = _parse_wav_header_duration(head, path)
        return x
    raise ValueError(f"unsupported audio format: {path}")


def _parse_wav_header_duration(data: bytes, path: str) -> tuple[float, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file: {path}")
    pos = 12
    byte_rate = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        if cid == b"fmt ":
            byte_rate = int.from_bytes(data[pos + 16 : pos + 20], "little")
        elif cid == b"data":
            if not byte_rate:
                raise ValueError(f"WAV data chunk before fmt in {path}")
            return size / byte_rate, byte_rate
        pos += 8 + size + (size & 1)
    raise ValueError(f"no data chunk in {path}")


def resample(x: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_rate, target_rate)
    return resample_poly(x, target_rate // g, orig_rate // g).astype(np.float32)
