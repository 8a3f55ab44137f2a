// H.266 CABAC arithmetic decoder (spec 9.3.4): two-rate adaptive
// probability states, 9-bit range register.  Independent spec-style
// implementation; behavioural parity target vvc_cabac.c:813-911.
//
// Engine layout is built for speed, not spec prose: a 64-bit buffered
// bit reader (byte-at-a-time refill, zero-padded past the RBSP end),
// one-shot renormalization via count-leading-zeros, and per-context
// state packed into a single 8-byte record so a bin decode touches one
// cache line of model state.  The arithmetic is bit-exact with the
// spec flowcharts (and therefore with the reference engine).
#pragma once

#include <cstdint>
#include <cstring>

#include "cabac_tables.h"

namespace vvc {

struct CabacStates {
  // packed two-rate state: s0 (10-bit), s1 (14-bit), window shifts
  struct Ctx {
    uint16_t s0, s1;
    uint8_t sh0, sh1;
    uint16_t pad_;
  };
  Ctx ctx[kNumContexts];

  void init(int qp, int init_type) {
    if (qp < 0) qp = 0;
    if (qp > 63) qp = 63;
    for (int i = 0; i < kNumContexts; i++) {
      int init_value = kInitValues[init_type][i];
      int shift_idx = kInitValues[3][i];
      int m = (init_value >> 3) - 4;
      int n = (init_value & 7) * 18 + 1;
      int pre = ((m * (qp - 16)) >> 1) + n;
      pre = pre < 1 ? 1 : (pre > 127 ? 127 : pre);
      ctx[i].s0 = (uint16_t)(pre << 3);
      ctx[i].s1 = (uint16_t)(pre << 7);
      ctx[i].sh0 = (uint8_t)((shift_idx >> 2) + 2);
      ctx[i].sh1 = (uint8_t)((shift_idx & 3) + 3 + ctx[i].sh0);
    }
  }
};

class CabacDecoder {
 public:
  // data/size: RBSP slice payload; bitpos must be byte aligned.
  CabacDecoder(const uint8_t* data, size_t size, size_t bitpos)
      : data_(data), size_(size) {
    start_at(bitpos);
  }

  inline int decode(CabacStates& s, int ctx) {
    CabacStates::Ctx& c = s.ctx[ctx];
    int p_state = c.s1 + (c.s0 << 4);
    int val_mps = p_state >> 14;
    int q_range = range_ >> 5;
    int prob = val_mps ? 32767 - p_state : p_state;
    int lps = ((q_range * (prob >> 9)) >> 1) + 4;
    int bin;
    range_ -= lps;
    if (offset_ < range_) {
      bin = val_mps;
    } else {
      bin = 1 - val_mps;
      offset_ -= range_;
      range_ = lps;
    }
    if (range_ < 256) {
      // one-shot renorm: range in [4, 255] -> shift in [1, 6]
      int sh = __builtin_clz(range_) - 23;
      range_ <<= sh;
      offset_ = (offset_ << sh) | read_bits(sh);
    }
    // two-rate update, spec 9.3.4.3.2.2: s += (1023*bin >> sh) - (s >> sh)
    int mask = -bin;  // 0 or ~0
    c.s0 = (uint16_t)(c.s0 - (c.s0 >> c.sh0) + ((1023 & mask) >> c.sh0));
    c.s1 = (uint16_t)(c.s1 - (c.s1 >> c.sh1) + ((16383 & mask) >> c.sh1));
    return bin;
  }

  inline int bypass() {
    offset_ = (offset_ << 1) | read_bits(1);
    if (offset_ >= range_) {
      offset_ -= range_;
      return 1;
    }
    return 0;
  }

  inline uint32_t bypass_bits(int n) {
    // n sequential bypass bins with constant range == one euclidean
    // division: value = floor(ext / range), offset' = ext % range
    uint32_t v = 0;
    while (n > 0) {
      int k = n < 20 ? n : 20;  // keep ext within 32 bits (offset < 2^9)
      uint32_t ext = (offset_ << k) | read_bits(k);
      v = (v << k) | (ext / range_);
      offset_ = ext % range_;
      n -= k;
    }
    return v;
  }

  int terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    if (range_ < 256) {
      int sh = __builtin_clz(range_) - 23;
      range_ <<= sh;
      offset_ = (offset_ << sh) | read_bits(sh);
    }
    return 0;
  }

  size_t bitpos() const { return next_bit_ - nbits_; }

  // Re-initialize the arithmetic engine at the next byte boundary: the
  // entry point of a new tile / WPP row (spec 9.3.1: initialization is
  // invoked after byte_alignment() following end_of_tile_one_bit /
  // end_of_subset_one_bit).
  void restart() { start_at((bitpos() + 7) & ~(size_t)7); }

  // Jump to an absolute (byte-aligned) bit position and re-initialize:
  // the signaled-entry-point path (ep_init_cabac_decoder).
  void reinit_at(size_t bitpos) { start_at(bitpos); }

 private:
  void start_at(size_t bitpos) {
    buf_ = 0;
    nbits_ = 0;
    next_bit_ = bitpos;
    range_ = 510;
    offset_ = read_bits(9);
  }

  inline uint32_t read_bits(int n) {
    if (nbits_ < n) refill();
    nbits_ -= n;
    return (uint32_t)(buf_ >> nbits_) & ((1u << n) - 1);
  }

  void refill() {
    // top up to >=48 buffered bits (byte granularity, zero-padded at
    // the end of the payload; trailing reads never affect decode state
    // because a conformant stream terminates first)
    size_t byte = next_bit_ >> 3;
    int frac = (int)(next_bit_ & 7);
    if (frac) {
      // only on the very first fill after a non-byte start (cannot
      // happen: starts are byte-aligned), keep bit-exact anyway
      uint8_t b = byte < size_ ? data_[byte] : 0;
      buf_ = (buf_ << (8 - frac)) | (b & ((1u << (8 - frac)) - 1));
      nbits_ += 8 - frac;
      next_bit_ += 8 - frac;
      byte++;
    }
    while (nbits_ <= 56) {
      uint8_t b = byte < size_ ? data_[byte] : 0;
      buf_ = (buf_ << 8) | b;
      nbits_ += 8;
      next_bit_ += 8;
      byte++;
    }
  }

  const uint8_t* data_;
  size_t size_;
  uint64_t buf_;     // bit buffer; low nbits_ bits are unconsumed
  int nbits_;
  size_t next_bit_;  // absolute bit index of the next unbuffered bit
  uint32_t range_, offset_;
};

}  // namespace vvc
