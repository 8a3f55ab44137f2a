// Bit-level readers and NAL handling for the native VVC host parser.
// Behavioural parity: libavcodec/get_bits.h, golomb.h, h2645_parse.c
// (independent implementation).
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace vvc {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  uint32_t u(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
      size_t byte = pos_ >> 3;
      int bit = byte < size_ ? (data_[byte] >> (7 - (pos_ & 7))) & 1 : 0;
      v = (v << 1) | bit;
      pos_++;
    }
    return v;
  }
  uint32_t flag() { return u(1); }

  uint32_t ue() {
    int zeros = 0;
    while (u(1) == 0) {
      if (++zeros > 32) throw std::runtime_error("bad exp-golomb");
    }
    return (1u << zeros) - 1 + u(zeros);
  }
  int32_t se() {
    uint32_t v = ue();
    return (v & 1) ? (int32_t)((v + 1) >> 1) : -(int32_t)(v >> 1);
  }
  void byte_align() { pos_ = (pos_ + 7) & ~(size_t)7; }
  size_t bitpos() const { return pos_; }
  size_t bits_left() const { return size_ * 8 - pos_; }
  const uint8_t* data() const { return data_; }
  size_t size() const { return size_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
};

struct Nal {
  int type;
  int layer_id;
  int temporal_id;
  std::vector<uint8_t> rbsp;  // emulation-prevention removed
  // rbsp positions where an emulation byte was removed (the
  // skipped_bytes_pos analog, h2645_parse.c): rbsp index that the
  // removed 0x03 preceded.  Used to map escaped entry-point offsets
  // to rbsp offsets (vvcdec.c:434-445).
  std::vector<size_t> skipped;
};

// H.266 NAL unit types (spec table 5).
enum NalType {
  NAL_TRAIL = 0, NAL_STSA = 1, NAL_RADL = 2, NAL_RASL = 3,
  NAL_IDR_W_RADL = 7, NAL_IDR_N_LP = 8, NAL_CRA = 9, NAL_GDR = 10,
  NAL_OPI = 12, NAL_DCI = 13, NAL_VPS = 14, NAL_SPS = 15, NAL_PPS = 16,
  NAL_PREFIX_APS = 17, NAL_SUFFIX_APS = 18, NAL_PH = 19, NAL_AUD = 20,
  NAL_EOS = 21, NAL_EOB = 22, NAL_PREFIX_SEI = 23, NAL_SUFFIX_SEI = 24,
};

inline bool nal_is_slice(int t) { return t <= NAL_GDR; }
inline bool nal_is_irap(int t) { return t >= NAL_IDR_W_RADL && t <= NAL_CRA; }
inline bool nal_is_idr(int t) { return t == NAL_IDR_W_RADL || t == NAL_IDR_N_LP; }

// Split an annex-B buffer into NALs, removing emulation prevention bytes.
inline std::vector<Nal> split_annexb(const uint8_t* data, size_t size) {
  std::vector<Nal> nals;
  std::vector<size_t> starts;
  for (size_t i = 0; i + 2 < size;) {
    if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
      starts.push_back(i + 3);
      i += 3;
    } else {
      i++;
    }
  }
  starts.push_back(size + 3);  // sentinel
  for (size_t s = 0; s + 1 < starts.size(); s++) {
    size_t beg = starts[s];
    size_t end = starts[s + 1] - 3;
    while (end > beg && data[end - 1] == 0) end--;  // trailing zeros
    if (end - beg < 3) continue;
    Nal nal;
    nal.layer_id = data[beg] & 0x3F;
    nal.type = data[beg + 1] >> 3;
    nal.temporal_id = (data[beg + 1] & 7) - 1;
    nal.rbsp.reserve(end - beg - 2);
    int zeros = 0;
    for (size_t i = beg + 2; i < end; i++) {
      uint8_t b = data[i];
      if (zeros >= 2 && b == 3) {
        zeros = 0;
        nal.skipped.push_back(nal.rbsp.size());
        continue;  // emulation prevention byte
      }
      nal.rbsp.push_back(b);
      zeros = (b == 0) ? zeros + 1 : 0;
    }
    nals.push_back(std::move(nal));
  }
  return nals;
}

}  // namespace vvc
