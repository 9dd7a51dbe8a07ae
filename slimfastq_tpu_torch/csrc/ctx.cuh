// What Kernel E (encode.cu) and Kernel D (coder.cu) share: the format's
// coder constants, the table law's helpers and the online context of a
// symbol-step (CtxState). Both kernels build every row with this one
// function, so the encode and the decode cannot drift apart.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t BOT = 1u << 16;
constexpr int PROB_BITS = 12;
constexpr int PROB_ONE = 1 << PROB_BITS;
constexpr int PROB_INIT = PROB_ONE / 2;
constexpr int PROB_MIN = 16;
constexpr int PROB_MAX = PROB_ONE - PROB_MIN;
constexpr int CAP_LOG2 = 4;
constexpr int CNT_BITS = 10;  // the format's collision-count field
constexpr int RENORM_ITERS = 4;
constexpr int CHUNK_SYMS = 8;  // symbol-steps of an emission chunk
// A table entry: p in bits 0-11, the visit count (saturated at the
// geometry's cap) from bit 12. The entry is 16 bits (a 4-bit count) where
// the cap is below 16, which every built-in level's is, else 32 bits (a
// 10-bit count: the law's ceil_log2 saturates at 10, so no cap passes 512);
// coder_torch.entry_bytes chooses, and each kernel takes the entry's type
// as a template argument.
constexpr int P_MASK = PROB_ONE - 1;
constexpr int VIS_SHIFT = PROB_BITS;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int MAX_BLOCKS = 256;  // blocks a launch: coder_torch's too

enum Kind { QUAL = 0, SEQ = 1, BYTE = 2, FLAG = 3 };

// #{j < 10 : c > 2^j}: ceil_log2 of a count, saturating at 10, 0 for c <= 1
__device__ __forceinline__ int ceil_log2(int c) {
  return c > 1 ? min(32 - __clz(c - 1), 10) : 0;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Geo {
  int table_size, sac_base, rate, rate_lo, vcap;
};

// The delta of one lane coding `one` against an entry that reads p after
// vis prior visits and n real lanes in this bit-step (ranger.table_update):
// the shift min(rate, rate_lo + ceil_log2(vis + 1)) where the geometry
// warms up, scaled down by 2^(ceil_log2(m) - CAP_LOG2) where the format's
// 10-bit count field, which holds m = n mod 1024, reads more than
// 2^CAP_LOG2 (it reads m < 512 as is, 512..1023 negative and 0 as 0,
// whatever the lane count); the negative delta shifts arithmetically.
template <bool WARM>
__device__ __forceinline__ int law_delta(const Geo& g, int p, int vis, int n,
                                         bool one) {
  const int r = WARM ? min(g.rate, g.rate_lo + ceil_log2(vis + 1)) : g.rate;
  int d = one ? -(p >> r) : (PROB_ONE - p) >> r;
  const int m = n & ((1 << CNT_BITS) - 1);
  if (m > (1 << CAP_LOG2) && m < (1 << (CNT_BITS - 1)))
    d >>= 32 - __clz(m - 1) - CAP_LOG2;
  return d;
}

__device__ __forceinline__ bool renorm_needed(uint32_t low, uint32_t rng,
                                              bool* agree) {
  *agree = (low ^ (low + rng)) < TOP;
  return *agree || rng < BOT;
}

// Online context of one symbol-step (streams_jax._ctx_step/_ctx_advance),
// the one function Kernels E and D both build their rows with.
struct Ctx {
  int kind, depth, num_ctx;
  int k0, k1, k2, k3;  // qual: q2_bits, delta_bits, pos_bits, pos_shift;
                       // seq: order, match_bits, tree_ctx; byte: order;
                       // flag: hist_bits
};

__device__ __forceinline__ uint32_t qdelta_code(uint32_t a, uint32_t b) {
  const int d = (int)a - (int)b;
  if (d == 0) return 0;
  if (d > 0 && d <= 3) return 1;
  if (d < 0 && d >= -3) return 2;
  return 3;
}

// A lane's context state: qual (a, b), the two symbols before; seq h, the
// order-k history; byte the symbol before; flag the hist_bits history.
struct CtxState {
  uint32_t sa = 0, sb = 0;

  // the first table entry of a symbol-step: its context row times the
  // tree's nodes (the sacrificial row num_ctx where the step is not
  // active); a read start (rs) clears the history first. mf: the step lies
  // in a match span of a format-v5 SEQ stream coded with the family.
  __device__ __forceinline__ int row(const Ctx& cx, bool act, bool rs,
                                     uint32_t pos, bool mf) {
    uint32_t ctx;
    if (cx.kind == QUAL) {
      if (rs) sa = sb = 0;
      ctx = sa;
      int shift = cx.depth;
      if (cx.k0) {
        ctx |= (sb >> (cx.depth - cx.k0)) << shift;
        shift += cx.k0;
      }
      if (cx.k1) {
        ctx |= qdelta_code(sa, sb) << shift;
        shift += cx.k1;
      }
      if (cx.k2) ctx |= min(pos >> cx.k3, (1u << cx.k2) - 1) << shift;
    } else if (cx.kind == SEQ) {
      if (rs) sa = 0;
      if (mf) {  // the match family: tree_ctx + low bits of h
        ctx = (uint32_t)cx.k2 + (sa & ((1u << cx.k1) - 1));
      } else {
        const int j = min((int)pos, cx.k0);
        ctx = sa + ((1u << (2 * j)) - 1) / 3;
      }
    } else if (cx.kind == BYTE) {
      ctx = cx.k0 ? sa : 0;
    } else {
      ctx = sa;
    }
    return (act ? (int)ctx : cx.num_ctx) * ((1 << cx.depth) - 1);
  }

  // the step's symbol enters the history (0 where the step is not active)
  __device__ __forceinline__ void advance(const Ctx& cx, uint32_t sym) {
    if (cx.kind == QUAL) {
      sb = sa;
      sa = sym;
    } else if (cx.kind == SEQ) {
      sa = ((sa << 2) | sym) & ((1u << (2 * cx.k0)) - 1);
    } else if (cx.kind == BYTE) {
      sa = sym;
    } else {
      sa = ((sa << 1) | sym) & ((1u << cx.k0) - 1);
    }
  }
};

}  // namespace
