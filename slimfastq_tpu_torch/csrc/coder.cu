// Lockstep lane coder: Kernel E (lane_encode) and Kernel D (lane_decode).
//
// Replaces: slimfastq_tpu/ops/streams_jax.py `_build_encode` (the encode
// coder scan) and `_build_decode` (the decode coder scan). Those are plain
// XLA programs, not Pallas, but they carry the whole coding loop; in eager
// PyTorch the same loop would be ~30 tensor ops per bit-step, i.e. over a
// million launches per stream per 64k-record block.
//
// Contract (byte-identical to the JAX package and its NumPy oracle,
// ranger_np.py): W lanes advance in lockstep, one binary decision per lane
// per bit-step, through a carry-less 32-bit range coder with byte renorm.
// All lanes share one adaptive table of int32 entries (12-bit probability
// in the low bits, a collision-count marker in bits 22-31 during a step)
// under the batch-synchronous collision-capped law of
// ranger_np.table_update: every lane reads the table as it stood after
// all lanes deposited their markers, all deltas merge by (wrapping)
// addition, then touched entries are clamped. Geometries with
// 0 < rate_lo < rate also keep a visit table (format-v4 warm-up).
//
// Design: one CTA per stream, one thread per lane (blockDim = W <= 1024).
// The table (and the visit table) lives in global memory, where it stays
// L2-resident (L3 SEQ: 4,194,306 entries = 16.8 MB, plus a visit table of
// the same size; L3 QUAL: 8,193 x 63 entries = 2.1 MB). One bit-step is
// four phases separated by __syncthreads():
//   1. atomicAdd(table[idx], 1 << 22) for real (non-sacrificial) entries;
//   2. read `marked` and `vis` (every lane sees every marker, no delta);
//      run the coder step, compute the delta;
//   3. atomicAdd(table[idx], delta - (1 << 22)), atomicAdd(vtab[idx], 1);
//   4. table[idx] = clamp(table[idx]) (colliding lanes store one value).
// atomicAdd on int wraps exactly as the format's 10-bit count field needs
// (at W = 1024 a SEQ read start puts >= 512 lanes on one entry). Table
// reads go through __ldcg so that no stale L1 line is ever observed.
//
// Bound on the H100: latency of a serial chain, not bytes or operations.
// QUAL at the 64k-record block runs 6,400 steps x 6 bits = 38,400
// bit-steps, each four block-wide barriers plus L2 atomics, on one SM.
// The design makes no attempt to hide that; the queued work is SEQ and
// QUAL on two CUDA streams, fusing the schedule into Kernel E, tables in
// (distributed) shared memory and W > 1024.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t BOT = 1u << 16;
constexpr int PROB_BITS = 12;
constexpr int PROB_ONE = 1 << PROB_BITS;
constexpr int PROB_MIN = 16;
constexpr int PROB_MAX = PROB_ONE - PROB_MIN;
constexpr int CAP_LOG2 = 4;
constexpr int CNT_SHIFT = 22;
constexpr int MARK = 1 << CNT_SHIFT;
constexpr int RENORM_ITERS = 4;

enum Kind { QUAL = 0, SEQ = 1, BYTE = 2, FLAG = 3 };

// #{j < 10 : c > 2^j}: ceil_log2 of a count, saturating at 10
__device__ __forceinline__ int lg10(int c) {
  int lg = 0;
#pragma unroll
  for (int j = 0; j < 10; ++j) lg += c > (1 << j);
  return lg;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Table law state of one lane for one bit-step.
struct Law {
  int* table;
  int* vtab;  // nullptr unless warm-up
  int sac_base, rate, rate_lo;

  // phase 1, barrier, phase 2 read: returns `marked`, sets *vis
  __device__ __forceinline__ int mark(int idx, bool real, int* vis) const {
    if (real) atomicAdd(table + idx, MARK);
    __syncthreads();
    *vis = vtab ? min(__ldcg(vtab + idx), 1024) : 0;
    return __ldcg(table + idx);
  }

  __device__ __forceinline__ int delta(int marked, int p, bool one,
                                       int vis) const {
    int r = vtab ? min(rate, rate_lo + lg10(vis + 1)) : rate;
    int d = one ? -(p >> r) : (PROB_ONE - p) >> r;
    int cnt = marked >> CNT_SHIFT;  // arithmetic: a wrapped count is <= 0
    return d >> max(lg10(cnt) - CAP_LOG2, 0);
  }

  // barrier, phase 3, barrier, phase 4, barrier
  __device__ __forceinline__ void update(int idx, bool real, int d) const {
    __syncthreads();
    if (real) {
      atomicAdd(table + idx, d - MARK);
      if (vtab) atomicAdd(vtab + idx, 1);
    }
    __syncthreads();
    if (real) {
      int v = __ldcg(table + idx);
      __stcg(table + idx, clampi(v, PROB_MIN, PROB_MAX));
    }
    __syncthreads();
  }
};

__device__ __forceinline__ bool renorm_needed(uint32_t low, uint32_t rng,
                                              bool* agree) {
  *agree = (low ^ (low + rng)) < TOP;
  return *agree || rng < BOT;
}

__global__ void lane_encode_kernel(const int* __restrict__ idx_c,
                                   const int* __restrict__ bit_c, int NC,
                                   int KD, int W, Law law, int CB,
                                   uint8_t* __restrict__ ebufs,
                                   int* __restrict__ eptrs,
                                   uint32_t* __restrict__ low_out,
                                   int* __restrict__ emax) {
  const int w = threadIdx.x;
  uint32_t low = 0, rng = 0xFFFFFFFFu;
  int emx = 0;
  for (int c = 0; c < NC; ++c) {
    uint8_t* eb = ebufs + ((size_t)c * W + w) * CB;
    int eptr = 0;
    for (int i = 0; i < KD; ++i) {
      const size_t at = ((size_t)c * KD + i) * W + w;
      const int idx = idx_c[at];
      const bool one = bit_c[at] != 0;
      const bool real = idx < law.sac_base;
      int vis;
      const int marked = law.mark(idx, real, &vis);
      const int p = clampi(marked & (MARK - 1), PROB_MIN, PROB_MAX);
      const uint32_t split = (rng >> PROB_BITS) * (uint32_t)p;
      if (one) {
        low += split;
        rng -= split;
      } else {
        rng = split;
      }
      for (int r = 0; r < RENORM_ITERS; ++r) {
        bool agree;
        if (!renorm_needed(low, rng, &agree)) break;  // state is final
        if (!agree) rng = (0u - low) & (BOT - 1);
        if (eptr < CB) eb[eptr] = (uint8_t)(low >> 24);
        ++eptr;  // counted past CB: the caller reruns with hard buffers
        low <<= 8;
        rng <<= 8;
      }
      law.update(idx, real, real ? law.delta(marked, p, one, vis) : 0);
    }
    eptrs[(size_t)c * W + w] = eptr;
    emx = max(emx, eptr);
  }
  low_out[w] = low;
  atomicMax(emax, emx);
}

// Online context of one symbol-step (streams_jax._ctx_step/_ctx_advance).
struct Ctx {
  int kind, depth, num_ctx;
  int k0, k1, k2, k3;  // qual: q2_bits, delta_bits, pos_bits, pos_shift;
                       // seq/byte: order; flag: hist_bits
};

__device__ __forceinline__ uint32_t qdelta_code(uint32_t a, uint32_t b) {
  const int d = (int)a - (int)b;
  if (d == 0) return 0;
  if (d > 0 && d <= 3) return 1;
  if (d < 0 && d >= -3) return 2;
  return 3;
}

__global__ void lane_decode_kernel(const uint8_t* __restrict__ payload,
                                   int Lb, const int* __restrict__ lens,
                                   const int* __restrict__ acts,
                                   const int* __restrict__ poss,
                                   const int* __restrict__ resets, int Sp,
                                   int W, Law law, Ctx cx,
                                   uint8_t* __restrict__ syms) {
  const int w = threadIdx.x;
  const uint8_t* row = payload + (size_t)w * Lb;
  const int len = lens[w];
  int ptr = 0;
  // next payload byte of this lane; 0 past its end (read_bytes)
  auto next = [&]() -> uint32_t {
    const uint32_t b = ptr < len ? row[min(ptr, Lb - 1)] : 0u;
    ++ptr;
    return b;
  };
  uint32_t low = 0, rng = 0xFFFFFFFFu, code = 0;
  for (int r = 0; r < 4; ++r) code = (code << 8) | next();
  uint32_t sa = 0, sb = 0;  // qual: (a, b); seq: h; byte: prev; flag: hist
  const int nodes = (1 << cx.depth) - 1;
  for (int t = 0; t < Sp; ++t) {
    const size_t at = (size_t)t * W + w;
    const bool act = acts[at] != 0;
    const bool rs = resets[at] != 0;
    const uint32_t pos = (uint32_t)poss[at];
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
      const int j = min((int)pos, cx.k0);
      ctx = sa + ((1u << (2 * j)) - 1) / 3;
    } else if (cx.kind == BYTE) {
      ctx = cx.k0 ? sa : 0;
    } else {
      ctx = sa;
    }
    const int base = (act ? (int)ctx : cx.num_ctx) * nodes;
    int node = 1;
    for (int d = 0; d < cx.depth; ++d) {
      const int idx = base + node - 1;
      const bool real = idx < law.sac_base;
      int vis;
      const int marked = law.mark(idx, real, &vis);
      const int p = clampi(marked & (MARK - 1), PROB_MIN, PROB_MAX);
      const uint32_t split = (rng >> PROB_BITS) * (uint32_t)p;
      const bool one = code - low >= split;
      if (one) {
        low += split;
        rng -= split;
      } else {
        rng = split;
      }
      for (int r = 0; r < RENORM_ITERS; ++r) {
        bool agree;
        if (!renorm_needed(low, rng, &agree)) break;
        if (!agree) rng = (0u - low) & (BOT - 1);
        code = (code << 8) | next();
        low <<= 8;
        rng <<= 8;
      }
      law.update(idx, real, real ? law.delta(marked, p, one, vis) : 0);
      node = 2 * node + one;
    }
    const uint32_t sym = act ? (uint32_t)(node - (1 << cx.depth)) : 0u;
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
    syms[at] = (uint8_t)sym;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int lane_encode(const int* idx_c, const int* bit_c, int NC, int KD, int W,
                int* table, int* vtab, int sac_base, int rate, int rate_lo,
                int CB, uint8_t* ebufs, int* eptrs, uint32_t* low,
                int* emax, cudaStream_t stream) {
  Law law{table, vtab, sac_base, rate, rate_lo};
  lane_encode_kernel<<<1, W, 0, stream>>>(idx_c, bit_c, NC, KD, W, law, CB,
                                          ebufs, eptrs, low, emax);
  return (int)cudaGetLastError();
}

int lane_decode(const uint8_t* payload, int Lb, const int* lens,
                const int* acts, const int* poss, const int* resets, int Sp,
                int W, int* table, int* vtab, int sac_base, int rate,
                int rate_lo, int depth, int kind, int num_ctx, int k0, int k1,
                int k2, int k3, uint8_t* syms, cudaStream_t stream) {
  Law law{table, vtab, sac_base, rate, rate_lo};
  Ctx cx{kind, depth, num_ctx, k0, k1, k2, k3};
  lane_decode_kernel<<<1, W, 0, stream>>>(payload, Lb, lens, acts, poss,
                                          resets, Sp, W, law, cx, syms);
  return (int)cudaGetLastError();
}

}  // extern "C"
