// zstd frame decompressor (RFC 8878), bound from Python with ctypes
// (tensorflowasr_tpu_torch/native/zstd.py). It decodes concatenated frames,
// skips skippable frames, and reads raw, RLE and compressed blocks: raw, RLE
// and Huffman literals (one or four streams, new or repeated tables, weights
// direct or FSE-coded), sequences in predefined, RLE, FSE and repeat modes
// with the three repeat offsets, and verifies the XXH64 content checksum.
// A frame that names a dictionary, and any malformed input, is refused with
// a message. The plain version is zstd_decode_python in zstd.py; the two
// follow the same steps in the same order.
//
// C interface:
//   void* tfasr_zstd_decode(const uint8_t* src, size_t n, int64_t* out_len, char* err, size_t err_cap)
//     returns a malloc'd buffer of *out_len bytes, or NULL with err filled;
//   void tfasr_zstd_free(void* p).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& what) : std::runtime_error(what) {}
};

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 1u << 17;

constexpr uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,  12,   13,   14,   15,   16,   18,
                                  20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,  16,  17,  18,  19,   20,   21,   22,   23,   24,    25,    26,    27,    28,   29,
                                  30, 31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

inline uint32_t le32(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24; }

inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // the library is built for little-endian hosts only
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull, P3 = 1609587929392839161ull,
                   P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
    ++p;
  }
  h = (h ^ (h >> 33)) * P2;
  h = (h ^ (h >> 29)) * P3;
  return h ^ (h >> 32);
}

// ---------------------------------------------------------------- bit readers
// A backward bitstream: read from its last bit down after the end marker (the
// highest set bit of the last byte). Reads past the start yield zeros and
// leave pos negative.
struct BackBits {
  const uint8_t* buf;
  size_t n;
  int64_t pos;
  BackBits(const uint8_t* b, size_t len) : buf(b), n(len) {
    if (len == 0 || b[len - 1] == 0) throw Corrupt("bitstream without its end marker");
    pos = int64_t(len - 1) * 8 + highbit(b[len - 1]);
  }
  // the 64 bits starting at byte i (bytes past the end read as zero)
  inline uint64_t word(int64_t i) const {
    if (i + 8 <= int64_t(n)) return le64(buf + i);
    uint64_t v = 0;
    for (int64_t k = int64_t(n) - 1; k >= i; --k) v = (v << 8) | buf[k];
    return v;
  }
  inline uint32_t read(int nb) {  // nb <= 32
    if (nb == 0) return 0;
    pos -= nb;
    const uint64_t mask = (uint64_t(1) << nb) - 1;
    if (pos >= 0) return uint32_t((word(pos >> 3) >> (pos & 7)) & mask);
    if (pos + nb <= 0) return 0;
    return uint32_t((word(0) << -pos) & mask);
  }
};

// ---------------------------------------------------------------- FSE
struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol, nbits;
  std::vector<uint16_t> base;
};

// An FSE table description at buf[start..len): fills norm and log; returns the bytes used.
size_t read_fse_description(const uint8_t* buf, size_t len, size_t start, int max_log, int max_symbol, std::vector<int16_t>& norm, int& log) {
  uint64_t bit = uint64_t(start) * 8;
  auto peek = [&](int nb) -> uint32_t {
    uint64_t byte = bit >> 3;
    uint64_t v = 0;
    for (int k = 0; k < 4 && byte + k < len; ++k) v |= uint64_t(buf[byte + k]) << (8 * k);
    return uint32_t((v >> (bit & 7)) & ((uint64_t(1) << nb) - 1));
  };
  if (start >= len) throw Corrupt("truncated FSE table description");
  log = int(peek(4)) + 5;
  bit += 4;
  if (log > max_log) throw Corrupt("FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  norm.clear();
  bool previous0 = false;
  while (remaining > 1 && int(norm.size()) <= max_symbol) {
    if (previous0) {
      while (true) {
        uint32_t repeat = peek(2);
        bit += 2;
        norm.insert(norm.end(), repeat, 0);
        if (repeat != 3) break;
        if (int(norm.size()) > max_symbol) break;
      }
      if (int(norm.size()) > max_symbol) throw Corrupt("FSE table description past the largest symbol");
    }
    int most = (2 * threshold - 1) - remaining;
    uint32_t bits = peek(nb);
    int value;
    if (int(bits & uint32_t(threshold - 1)) < most) {
      value = int(bits & uint32_t(threshold - 1));
      bit += nb - 1;
    } else {
      value = int(bits & uint32_t(2 * threshold - 1));
      if (value >= threshold) value -= most;
      bit += nb;
    }
    int count = value - 1;
    remaining -= count < 0 ? -count : count;
    norm.push_back(int16_t(count));
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  size_t used = size_t((bit - uint64_t(start) * 8 + 7) / 8);
  if (remaining != 1 || start + used > len) throw Corrupt("malformed FSE table description");
  return used;
}

void build_fse(const int16_t* norm, size_t count, int log, FseTable& t) {
  const int size = 1 << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  int high = size - 1;
  std::vector<uint32_t> next(count);
  for (size_t s = 0; s < count; ++s) {
    if (norm[s] == -1) {
      t.symbol[high--] = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < count; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = uint8_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) throw Corrupt("FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    uint32_t x = next[t.symbol[u]]++;
    int b = log - highbit(x);
    t.nbits[u] = uint8_t(b);
    t.base[u] = uint16_t((x << b) - uint32_t(size));
  }
}

void rle_fse(uint8_t symbol, FseTable& t) {
  t.log = 0;
  t.symbol.assign(1, symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// ---------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, nbits;
};

void build_huffman(std::vector<uint8_t> weights, HufTable& t) {
  if (weights.size() > 255) throw Corrupt("malformed Huffman weights");
  uint32_t total = 0;
  for (uint8_t w : weights) {
    if (w > 11) throw Corrupt("malformed Huffman weights");
    total += (1u << w) >> 1;
  }
  if (total == 0) throw Corrupt("Huffman weights all zero");
  const int max_bits = highbit(total) + 1;
  const uint32_t left = (1u << max_bits) - total;
  if ((left & (left - 1)) || max_bits > 11) throw Corrupt("Huffman weights do not sum to a power of two");
  weights.push_back(uint8_t(highbit(left) + 1));
  std::vector<int> bits(weights.size());
  std::vector<uint32_t> count(max_bits + 2, 0), start(max_bits + 2, 0);
  for (size_t s = 0; s < weights.size(); ++s) {
    bits[s] = weights[s] ? max_bits + 1 - weights[s] : 0;
    if (bits[s]) ++count[bits[s]];
  }
  for (int b = max_bits; b >= 1; --b) start[b - 1] = start[b] + count[b] * (1u << (max_bits - b));
  const uint32_t size = 1u << max_bits;
  t.max_bits = max_bits;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  for (size_t s = 0; s < weights.size(); ++s) {
    int b = bits[s];
    if (!b) continue;
    uint32_t n = 1u << (max_bits - b);
    if (start[b] + n > size) throw Corrupt("malformed Huffman weights");
    std::memset(&t.symbol[start[b]], int(s), n);
    std::memset(&t.nbits[start[b]], b, n);
    start[b] += n;
  }
}

// A Huffman tree description at the start of data: fills t; returns the bytes used.
size_t huffman_description(const uint8_t* data, size_t len, HufTable& t) {
  if (len == 0) throw Corrupt("truncated Huffman tree description");
  const uint8_t head = data[0];
  std::vector<uint8_t> weights;
  if (head >= 128) {
    const size_t n = head - 127, used = 1 + (n + 1) / 2;
    if (used > len) throw Corrupt("truncated Huffman weights");
    for (size_t i = 0; i < n; ++i) weights.push_back(i % 2 == 0 ? data[1 + i / 2] >> 4 : data[1 + i / 2] & 15);
    build_huffman(std::move(weights), t);
    return used;
  }
  const size_t used = 1 + head;
  if (used > len || head == 0) throw Corrupt("truncated FSE-coded Huffman weights");
  const uint8_t* body = data + 1;
  std::vector<int16_t> norm;
  int log;
  const size_t n = read_fse_description(body, head, 0, 6, 255, norm, log);
  FseTable f;
  build_fse(norm.data(), norm.size(), log, f);
  BackBits bits(body + n, head - n);
  uint32_t s1 = bits.read(log), s2 = bits.read(log);
  while (true) {
    weights.push_back(f.symbol[s1]);
    s1 = f.base[s1] + bits.read(f.nbits[s1]);
    if (bits.pos < 0) {
      weights.push_back(f.symbol[s2]);
      break;
    }
    weights.push_back(f.symbol[s2]);
    s2 = f.base[s2] + bits.read(f.nbits[s2]);
    if (bits.pos < 0) {
      weights.push_back(f.symbol[s1]);
      break;
    }
    if (weights.size() > 255) throw Corrupt("too many Huffman weights");
  }
  build_huffman(std::move(weights), t);
  return used;
}

void huffman_stream(const uint8_t* data, size_t len, uint8_t* out, size_t n, const HufTable& t) {
  BackBits bits(data, len);
  const uint32_t mask = (1u << t.max_bits) - 1;
  uint32_t state = bits.read(t.max_bits);
  for (size_t i = 0; i < n; ++i) {
    out[i] = t.symbol[state];
    const int b = t.nbits[state];
    state = ((state << b) & mask) | bits.read(b);
  }
  if (bits.pos != -t.max_bits) throw Corrupt("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------- blocks
struct FrameState {
  bool has_huffman = false;
  HufTable huffman;
  bool has_table[3] = {false, false, false};  // ll, of, ml
  FseTable tables[3];
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

// Fills st.literals from block[pos..); returns the position after the literals section.
size_t literals(const uint8_t* block, size_t len, size_t pos, FrameState& st) {
  if (pos >= len) throw Corrupt("truncated literals section");
  const uint8_t b0 = block[pos];
  const int kind = b0 & 3, size_format = (b0 >> 2) & 3;
  if (kind == 0 || kind == 1) {
    size_t regen, head;
    if (size_format == 0 || size_format == 2) {
      regen = b0 >> 3;
      head = 1;
    } else if (size_format == 1) {
      if (pos + 2 > len) throw Corrupt("truncated literals header");
      regen = (b0 >> 4) + (size_t(block[pos + 1]) << 4);
      head = 2;
    } else {
      if (pos + 3 > len) throw Corrupt("truncated literals header");
      regen = (b0 >> 4) + (size_t(block[pos + 1]) << 4) + (size_t(block[pos + 2]) << 12);
      head = 3;
    }
    pos += head;
    if (kind == 0) {
      if (pos + regen > len) throw Corrupt("truncated raw literals");
      st.literals.assign(block + pos, block + pos + regen);
      return pos + regen;
    }
    if (pos >= len) throw Corrupt("truncated RLE literals");
    st.literals.assign(regen, block[pos]);
    return pos + 1;
  }
  static const int kStreams[4] = {1, 4, 4, 4}, kHead[4] = {3, 3, 4, 5}, kWidth[4] = {10, 10, 14, 18};
  const int streams = kStreams[size_format], head = kHead[size_format], width = kWidth[size_format];
  if (pos + head > len) throw Corrupt("truncated literals header");
  uint64_t h = 0;
  for (int k = 0; k < head; ++k) h |= uint64_t(block[pos + k]) << (8 * k);
  const size_t regen = (h >> 4) & ((1u << width) - 1), comp = (h >> (4 + width)) & ((1u << width) - 1);
  pos += head;
  if (pos + comp > len || regen > kBlockMax) throw Corrupt("truncated Huffman literals");
  const uint8_t* data = block + pos;
  size_t dlen = comp;
  pos += comp;
  if (kind == 2) {
    const size_t used = huffman_description(data, dlen, st.huffman);
    st.has_huffman = true;
    data += used;
    dlen -= used;
  } else if (!st.has_huffman) {
    throw Corrupt("treeless literals without an earlier Huffman table");
  }
  st.literals.resize(regen);
  if (streams == 1) {
    huffman_stream(data, dlen, st.literals.data(), regen, st.huffman);
    return pos;
  }
  if (dlen < 6) throw Corrupt("truncated jump table");
  const size_t s1 = data[0] | size_t(data[1]) << 8, s2 = data[2] | size_t(data[3]) << 8, s3 = data[4] | size_t(data[5]) << 8;
  if (6 + s1 + s2 + s3 > dlen) throw Corrupt("jump table past the literals");
  const size_t s4 = dlen - 6 - s1 - s2 - s3;
  const size_t each = (regen + 3) / 4;
  if (regen < 3 * each) throw Corrupt("literals too short for four streams");
  const size_t sizes[4] = {s1, s2, s3, s4}, counts[4] = {each, each, each, regen - 3 * each};
  size_t at = 6, out = 0;
  for (int k = 0; k < 4; ++k) {
    huffman_stream(data + at, sizes[k], st.literals.data() + out, counts[k], st.huffman);
    at += sizes[k];
    out += counts[k];
  }
  return pos;
}

size_t sequence_table(int kind, int mode, const uint8_t* block, size_t len, size_t pos, FrameState& st) {
  static const int kMaxLog[3] = {9, 8, 9}, kMaxSymbol[3] = {35, 31, 52};
  FseTable& t = st.tables[kind];
  if (mode == 0) {
    if (kind == 0) build_fse(kLLDefault, 36, 6, t);
    else if (kind == 1) build_fse(kOFDefault, 29, 5, t);
    else build_fse(kMLDefault, 53, 6, t);
  } else if (mode == 1) {
    if (pos >= len || block[pos] > kMaxSymbol[kind]) throw Corrupt("bad RLE sequence symbol");
    rle_fse(block[pos], t);
    ++pos;
  } else if (mode == 2) {
    std::vector<int16_t> norm;
    int log;
    pos += read_fse_description(block, len, pos, kMaxLog[kind], kMaxSymbol[kind], norm, log);
    build_fse(norm.data(), norm.size(), log, t);
  } else if (!st.has_table[kind]) {
    throw Corrupt("repeat mode without an earlier table");
  }
  st.has_table[kind] = true;
  return pos;
}

void compressed_block(const uint8_t* block, size_t len, std::vector<uint8_t>& out, FrameState& st) {
  size_t pos = literals(block, len, 0, st);
  const size_t start = out.size();
  const std::vector<uint8_t>& lits = st.literals;
  if (pos >= len) throw Corrupt("truncated sequences section");
  uint32_t n = block[pos++];
  size_t at = 0;
  if (n == 0) {
    if (pos != len) throw Corrupt("bytes after an empty sequences section");
  } else {
    if (n >= 128) {
      if (n < 255) {
        if (pos + 1 > len) throw Corrupt("truncated sequences header");
        n = ((n - 128) << 8) + block[pos++];
      } else {
        if (pos + 2 > len) throw Corrupt("truncated sequences header");
        n = block[pos] + (uint32_t(block[pos + 1]) << 8) + 0x7F00;
        pos += 2;
      }
    }
    if (pos >= len) throw Corrupt("truncated sequences header");
    const uint8_t modes = block[pos++];
    if (modes & 3) throw Corrupt("reserved bits set in the sequence modes");
    pos = sequence_table(0, modes >> 6, block, len, pos, st);
    pos = sequence_table(1, (modes >> 4) & 3, block, len, pos, st);
    pos = sequence_table(2, (modes >> 2) & 3, block, len, pos, st);
    const FseTable &ll = st.tables[0], &of = st.tables[1], &ml = st.tables[2];
    BackBits bits(block + pos, len - pos);
    uint32_t ll_s = bits.read(ll.log), of_s = bits.read(of.log), ml_s = bits.read(ml.log);
    uint32_t* rep = st.rep;
    for (uint32_t i = 0; i < n; ++i) {
      const int of_code = of.symbol[of_s], ll_code = ll.symbol[ll_s], ml_code = ml.symbol[ml_s];
      if (of_code > 31 || ll_code > 35 || ml_code > 52) throw Corrupt("sequence code out of range");
      const uint64_t value = (uint64_t(1) << of_code) + bits.read(of_code);
      const size_t match = kMLBase[ml_code] + bits.read(kMLBits[ml_code]);
      const size_t lit = kLLBase[ll_code] + bits.read(kLLBits[ll_code]);
      uint64_t offset;
      if (value > 3) {
        offset = value - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        const uint32_t idx = uint32_t(value - 1) + (lit == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx < 3 ? rep[idx] : rep[0] - 1;
          if (offset == 0) throw Corrupt("repeat offset of zero");
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      if (at + lit > lits.size()) throw Corrupt("sequence past the literals");
      out.insert(out.end(), lits.begin() + at, lits.begin() + at + lit);
      at += lit;
      if (offset > out.size()) throw Corrupt("match offset before the start of the frame");
      if (out.size() - start + match > kBlockMax) throw Corrupt("block larger than 128 KiB");
      size_t src = out.size() - offset;
      const size_t dst = out.size();
      out.resize(dst + match);
      uint8_t* o = out.data();
      if (offset >= match) {
        std::memcpy(o + dst, o + src, match);
      } else {
        for (size_t k = 0; k < match; ++k) o[dst + k] = o[src + k];
      }
      if (i != n - 1) {
        ll_s = ll.base[ll_s] + bits.read(ll.nbits[ll_s]);
        ml_s = ml.base[ml_s] + bits.read(ml.nbits[ml_s]);
        of_s = of.base[of_s] + bits.read(of.nbits[of_s]);
      }
    }
    if (bits.pos != 0) throw Corrupt("sequence bitstream not consumed exactly");
  }
  out.insert(out.end(), lits.begin() + at, lits.end());
  if (out.size() - start > kBlockMax) throw Corrupt("block larger than 128 KiB");
}

// Decodes the frame at data[pos..); appends to out; returns the position after it.
size_t frame(const uint8_t* data, size_t len, size_t pos, std::vector<uint8_t>& out) {
  if (pos + 6 > len) throw Corrupt("truncated frame header");
  const uint8_t fhd = data[pos + 4];
  pos += 5;
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) throw Corrupt("reserved bit set in the frame header");
  if (!single) {
    if ((data[pos] >> 3) > 21) throw Corrupt("window larger than 2 GiB");
    ++pos;
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  const int dict_bytes = kDictBytes[dict_flag];
  if (pos + dict_bytes > len) throw Corrupt("truncated frame header");
  uint32_t dict_id = 0;
  for (int k = 0; k < dict_bytes; ++k) dict_id |= uint32_t(data[pos + k]) << (8 * k);
  pos += dict_bytes;
  if (dict_id) throw Corrupt("frame needs dictionary " + std::to_string(dict_id) + ", and no dictionary is supported");
  const int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + fcs_bytes > len) throw Corrupt("truncated frame header");
  bool has_size = fcs_bytes > 0;
  uint64_t size = 0;
  for (int k = 0; k < fcs_bytes; ++k) size |= uint64_t(data[pos + k]) << (8 * k);
  if (fcs_bytes == 2) size += 256;
  pos += fcs_bytes;
  const size_t start = out.size();
  FrameState st;
  // Matches reach back only within this frame: decode it into a buffer of its own when out holds earlier frames.
  std::vector<uint8_t> own;
  std::vector<uint8_t>& dst = start == 0 ? out : own;
  if (has_size && size <= (uint64_t(1) << 34)) dst.reserve(size);
  while (true) {
    if (pos + 3 > len) throw Corrupt("truncated block header");
    const uint32_t head = data[pos] | uint32_t(data[pos + 1]) << 8 | uint32_t(data[pos + 2]) << 16;
    pos += 3;
    const int last = head & 1, kind = (head >> 1) & 3;
    const size_t bsize = head >> 3;
    if (kind == 3) throw Corrupt("reserved block type");
    if (bsize > kBlockMax) throw Corrupt("block larger than 128 KiB");
    if (kind == 1) {
      if (pos >= len) throw Corrupt("truncated RLE block");
      dst.insert(dst.end(), bsize, data[pos]);
      ++pos;
    } else {
      if (pos + bsize > len) throw Corrupt("truncated block");
      if (kind == 0) dst.insert(dst.end(), data + pos, data + pos + bsize);
      else compressed_block(data + pos, bsize, dst, st);
      pos += bsize;
    }
    if (has_size && dst.size() > size) throw Corrupt("frame longer than its content size");
    if (last) break;
  }
  if (has_size && dst.size() != size) throw Corrupt("frame content size mismatch");
  if (checksum) {
    if (pos + 4 > len) throw Corrupt("truncated content checksum");
    if (le32(data + pos) != uint32_t(xxh64(dst.data(), dst.size()))) throw Corrupt("content checksum mismatch");
    pos += 4;
  }
  if (start != 0) out.insert(out.end(), own.begin(), own.end());
  return pos;
}

std::vector<uint8_t> decode(const uint8_t* data, size_t len) {
  if (len == 0) throw Corrupt("empty input");
  std::vector<uint8_t> out;
  size_t pos = 0;
  while (pos < len) {
    if (pos + 4 > len) throw Corrupt("truncated frame magic");
    const uint32_t magic = le32(data + pos);
    if ((magic & 0xFFFFFFF0u) == kSkippableMagic) {
      if (pos + 8 > len) throw Corrupt("truncated skippable frame");
      const uint64_t skip = le32(data + pos + 4);
      if (pos + 8 + skip > len) throw Corrupt("truncated skippable frame");
      pos += 8 + skip;
      continue;
    }
    if (magic != kFrameMagic) {
      char msg[48];
      std::snprintf(msg, sizeof msg, "bad frame magic 0x%08x", magic);
      throw Corrupt(msg);
    }
    pos = frame(data, len, pos, out);
  }
  return out;
}

}  // namespace

extern "C" {

void* tfasr_zstd_decode(const uint8_t* src, size_t n, int64_t* out_len, char* err, size_t err_cap) {
  try {
    std::vector<uint8_t> out = decode(src, n);
    void* p = std::malloc(out.size() ? out.size() : 1);
    if (!p) throw Corrupt("out of memory");
    if (!out.empty()) std::memcpy(p, out.data(), out.size());
    *out_len = int64_t(out.size());
    return p;
  } catch (const std::exception& e) {
    if (err_cap) {
      std::snprintf(err, err_cap, "%s", e.what());
    }
    return nullptr;
  } catch (...) {
    if (err_cap) std::snprintf(err, err_cap, "unknown error");
    return nullptr;
  }
}

void tfasr_zstd_free(void* p) { std::free(p); }

}  // extern "C"
