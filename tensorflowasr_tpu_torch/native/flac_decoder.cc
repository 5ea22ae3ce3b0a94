// Native FLAC decoder for the data loader (a copy of
// tensorflowasr_tpu/native/flac_decoder.cc).
//
// Audio decode is host CPU work that must keep ahead of the card, and the
// pure-Python decoder (data/audio.py:read_flac_python) is about 100x slower.
// This implements the same FLAC subset (constant/verbatim/fixed/LPC
// subframes, rice/rice2 residuals, all stereo decorrelations) behind a C ABI
// that native/__init__.py binds with ctypes.
//
// Built at first use by native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o _build/libtfasr_flac.so flac_decoder.cc

#include <cstdint>
#include <cstring>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size), pos_(0) {}

  inline uint32_t Read(int nbits) {
    uint32_t v = 0;
    while (nbits > 0) {
      size_t byte = pos_ >> 3;
      int avail = 8 - static_cast<int>(pos_ & 7);
      int take = nbits < avail ? nbits : avail;
      uint8_t cur = byte < size_ ? data_[byte] : 0;
      uint8_t window = (cur >> (avail - take)) & ((1u << take) - 1);
      v = (v << take) | window;
      pos_ += take;
      nbits -= take;
    }
    return v;
  }

  inline int64_t ReadSigned(int nbits) {
    if (nbits == 0) return 0;
    int64_t v = Read(nbits);
    if (v >= (int64_t{1} << (nbits - 1))) v -= int64_t{1} << nbits;
    return v;
  }

  inline uint32_t ReadUnary() {
    uint32_t count = 0;
    for (;;) {
      size_t byte = pos_ >> 3;
      if (byte >= size_) return count;  // corrupt stream guard
      int rem = 8 - static_cast<int>(pos_ & 7);
      uint8_t window = data_[byte] & ((1u << rem) - 1);
      if (window == 0) {
        count += rem;
        pos_ += rem;
      } else {
        int bl = 31 - __builtin_clz(window);
        int lead = rem - 1 - bl;
        count += lead;
        pos_ += lead + 1;
        return count;
      }
    }
  }

  inline void AlignByte() { pos_ = (pos_ + 7) & ~size_t{7}; }
  inline size_t BitPos() const { return pos_; }
  inline bool Ok() const { return (pos_ >> 3) <= size_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_;
};

uint64_t ReadUtf8Coded(BitReader& br) {
  uint32_t b0 = br.Read(8);
  if (b0 < 0x80) return b0;
  int n = 0;
  uint32_t mask = 0x40;
  while (b0 & mask) {
    n++;
    mask >>= 1;
  }
  uint64_t val = b0 & (mask - 1);
  for (int i = 0; i < n; i++) val = (val << 6) | (br.Read(8) & 0x3F);
  return val;
}

const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

// residual decode into out[0..n)
bool DecodeResiduals(BitReader& br, int order, int block_size, int64_t* out) {
  uint32_t method = br.Read(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = (1u << plen) - 1;
  int part_order = br.Read(4);
  int nparts = 1 << part_order;
  int idx = 0;
  for (int part = 0; part < nparts; part++) {
    int n = (block_size >> part_order) - (part == 0 ? order : 0);
    uint32_t k = br.Read(plen);
    if (k == escape) {
      int raw = br.Read(5);
      for (int i = 0; i < n; i++) out[idx++] = raw ? br.ReadSigned(raw) : 0;
    } else {
      for (int i = 0; i < n; i++) {
        uint64_t q = br.ReadUnary();
        uint64_t v = (q << k) | (k ? br.Read(k) : 0);
        out[idx++] = static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
      }
    }
    if (!br.Ok()) return false;
  }
  return true;
}

const int kFixedOrders[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

bool DecodeSubframe(BitReader& br, int block_size, int bps, int64_t* out, int64_t* scratch) {
  if (br.Read(1) != 0) return false;
  int sf_type = br.Read(6);
  int wasted = 0;
  if (br.Read(1)) {
    wasted = 1 + br.ReadUnary();
    bps -= wasted;
  }

  if (sf_type == 0) {  // constant
    int64_t v = br.ReadSigned(bps);
    for (int i = 0; i < block_size; i++) out[i] = v;
  } else if (sf_type == 1) {  // verbatim
    for (int i = 0; i < block_size; i++) out[i] = br.ReadSigned(bps);
  } else if (sf_type >= 8 && sf_type <= 12) {  // fixed
    int order = sf_type - 8;
    for (int i = 0; i < order; i++) out[i] = br.ReadSigned(bps);
    if (!DecodeResiduals(br, order, block_size, scratch)) return false;
    const int* c = kFixedOrders[order];
    for (int i = order; i < block_size; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += c[j] * out[i - 1 - j];
      out[i] = scratch[i - order] + acc;
    }
  } else if (sf_type >= 32) {  // LPC
    int order = sf_type - 31;
    for (int i = 0; i < order; i++) out[i] = br.ReadSigned(bps);
    int precision = br.Read(4) + 1;
    int shift = static_cast<int>(br.ReadSigned(5));
    int64_t coefs[32];
    for (int i = 0; i < order; i++) coefs[i] = br.ReadSigned(precision);
    if (!DecodeResiduals(br, order, block_size, scratch)) return false;
    for (int i = order; i < block_size; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coefs[j] * out[i - 1 - j];
      out[i] = scratch[i - order] + (acc >> shift);
    }
  } else {
    return false;
  }

  if (wasted) {
    for (int i = 0; i < block_size; i++) out[i] <<= wasted;
  }
  return true;
}

}  // namespace

extern "C" {

// Probe stream info. Returns 0 on success.
int tfasr_flac_info(const uint8_t* data, size_t size, int32_t* sample_rate, int32_t* channels,
                    int32_t* bits_per_sample, int64_t* total_samples) {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  for (;;) {
    if (pos + 4 > size) return -2;
    int last = data[pos] & 0x80;
    int btype = data[pos] & 0x7F;
    uint32_t length = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    if (btype == 0) {
      BitReader br(data + pos + 4, length);
      br.Read(16);  // min block
      br.Read(16);  // max block
      br.Read(24);
      br.Read(24);
      *sample_rate = br.Read(20);
      *channels = br.Read(3) + 1;
      *bits_per_sample = br.Read(5) + 1;
      *total_samples = (static_cast<int64_t>(br.Read(4)) << 32) | br.Read(32);
    }
    pos += 4 + length;
    if (last) break;
  }
  return 0;
}

// Decode full stream to interleaved int32 PCM (caller allocates
// total_samples * channels). Returns number of frames decoded or < 0 on error.
int64_t tfasr_flac_decode(const uint8_t* data, size_t size, int32_t* out, int64_t max_frames) {
  int32_t rate, channels, bps;
  int64_t total;
  if (tfasr_flac_info(data, size, &rate, &channels, &bps, &total) != 0) return -1;

  // skip metadata
  size_t pos = 4;
  for (;;) {
    int last = data[pos] & 0x80;
    uint32_t length = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4 + length;
    if (last) break;
  }

  BitReader br(data + pos, size - pos);
  int64_t written = 0;
  const int kMaxBlock = 65536;
  static thread_local int64_t ch_buf[8][kMaxBlock];
  static thread_local int64_t scratch[kMaxBlock];

  while (written < max_frames && br.Ok()) {
    size_t before = br.BitPos();
    uint32_t sync = br.Read(14);
    if (sync != 0x3FFE) {
      if (written >= total) break;  // trailing padding
      return -3;                    // lost sync mid-stream
    }
    br.Read(1);
    br.Read(1);
    int bs_code = br.Read(4);
    int sr_code = br.Read(4);
    int ch_code = br.Read(4);
    int ss_code = br.Read(3);
    br.Read(1);
    ReadUtf8Coded(br);
    int block_size;
    if (bs_code == 6) block_size = br.Read(8) + 1;
    else if (bs_code == 7) block_size = br.Read(16) + 1;
    else block_size = kBlockSizes[bs_code];
    if (sr_code == 12) br.Read(8);
    else if (sr_code == 13 || sr_code == 14) br.Read(16);
    int bps_f = kSampleSizes[ss_code];
    if (bps_f == 0) bps_f = bps;
    br.Read(8);  // CRC-8
    if (block_size <= 0 || block_size > kMaxBlock) return -4;

    int nch = channels;
    if (ch_code < 8) {
      nch = ch_code + 1;
      for (int c = 0; c < nch; c++)
        if (!DecodeSubframe(br, block_size, bps_f, ch_buf[c], scratch)) return -5;
    } else if (ch_code == 8) {  // left/side
      if (!DecodeSubframe(br, block_size, bps_f, ch_buf[0], scratch)) return -5;
      if (!DecodeSubframe(br, block_size, bps_f + 1, ch_buf[1], scratch)) return -5;
      for (int i = 0; i < block_size; i++) ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
      nch = 2;
    } else if (ch_code == 9) {  // right/side
      if (!DecodeSubframe(br, block_size, bps_f + 1, ch_buf[0], scratch)) return -5;
      if (!DecodeSubframe(br, block_size, bps_f, ch_buf[1], scratch)) return -5;
      for (int i = 0; i < block_size; i++) ch_buf[0][i] = ch_buf[1][i] + ch_buf[0][i];
      nch = 2;
    } else if (ch_code == 10) {  // mid/side
      if (!DecodeSubframe(br, block_size, bps_f, ch_buf[0], scratch)) return -5;
      if (!DecodeSubframe(br, block_size, bps_f + 1, ch_buf[1], scratch)) return -5;
      for (int i = 0; i < block_size; i++) {
        int64_t mid = ch_buf[0][i], side = ch_buf[1][i];
        int64_t left = ((mid << 1) | (side & 1)) + side;
        ch_buf[0][i] = left >> 1;
        ch_buf[1][i] = (left >> 1) - side;
      }
      nch = 2;
    } else {
      return -6;
    }

    br.AlignByte();
    br.Read(16);  // CRC-16

    int64_t n = block_size;
    if (written + n > max_frames) n = max_frames - written;
    for (int64_t i = 0; i < n; i++)
      for (int c = 0; c < nch; c++) out[(written + i) * channels + c] = static_cast<int32_t>(ch_buf[c][i]);
    written += n;
    (void)before;
  }
  return written;
}

}  // extern "C"
