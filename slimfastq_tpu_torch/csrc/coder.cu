// Lockstep lane coder: Kernel E (lane_encode) and Kernel D (lane_decode).
//
// Replaces: slimfastq_tpu/ops/streams_jax.py `_build_encode` (the encode
// coder scan) together with the schedule it reads, `_ctx_precompute` +
// `_build_schedule` / `_build_schedule_ll` (every bit-step's table index
// and bit, [NC, 8*depth, W] int32 each: 48 bytes a QUAL symbol), and
// `_build_decode` (the decode coder scan), both with and without
// `with_mflag` (format v5: a SEQ stream whose steps inside a match span
// code in the match-context family). Those are plain XLA programs, not
// Pallas, but they carry the whole coding loop; in eager PyTorch the same
// loop would be ~30 tensor ops per bit-step, i.e. over a million launches
// per stream per 64k-record block.
//
// Both kernels build each symbol-step's context row online from the same
// per-lane state (CtxState: the reference's _ctx_step / _ctx_advance), so
// E and D cannot drift apart: D from the symbols it decodes, E from the
// symbols it is given ([Sp, W] u8, with pos/reset [Sp, W] int32, the lane
// counts and a trial's match flags), which are known ahead, so nothing
// serialises on them. Bit j of a symbol takes entry
// row + ((1 << j) | (sym >> (depth - j))) - 1 and codes bit
// (sym >> (depth - 1 - j)) & 1; a step at or past its lane's count codes
// symbol 0 in the sacrificial row num_ctx.
//
// Contract (byte-identical to the JAX package and its NumPy oracle,
// ranger_np.py): W lanes advance in lockstep, one binary decision per lane
// per bit-step, through a carry-less 32-bit range coder with byte renorm.
// All lanes share one adaptive table under the batch-synchronous
// collision-capped law of ranger_np.table_mark + table_update: every lane
// reads the entry as it stood before the step, together with the number
// of real lanes on that entry in this step (the format's 10-bit count
// field: 512..1023 read negative, 1024 reads 0); the deltas, scaled down by
// that count, merge by addition; the entry is clamped to [16, 4080].
// Geometries with 0 < rate_lo < rate also count visits (format-v4
// warm-up): the shift is min(rate, rate_lo + ceil_log2(min(vis,1024)+1)).
//
// Bound on the H100: both kernels are a serial chain of bit-steps on one
// SM (QUAL at the 64k-record block: 6,400 steps x 6 bits = 38,400
// bit-steps). Kernel D's law couples the lanes at every bit-step, so its
// floor is bit-steps x one 1,024-thread barrier (barrier_loop below
// measures it). Kernel E needs no such barrier: its table's evolution
// depends only on its inputs, so the function itself is bound only by
// its bytes; the barriers are this design's cost, not the function's. At
// W = 1024 both run far above the barrier floor, bound by issuing ~200
// instructions per lane and bit-step for 32 warps on the SM's 4
// schedulers. A block's seven streams run as seven CTAs on their own CUDA
// streams, so a block costs its longest chain, not the sum; a window's B
// blocks run as B CTAs of one launch side by side (one SM each), so its
// bound is one block's chain, not B of them. Next: a decoupled encode (p
// of every decision by a per-entry scan, no barrier), QUAL's table in a
// cluster's distributed shared memory, W > 1024.
//
// Design: one CTA per stream of one block, one thread per lane (W <= 1024,
// rounded up to whole warps; the extra threads take part in barriers
// only). A launch codes one stream of each block of a window (also
// replacing parallel/mesh.py's vmap over blocks, mesh=None): CTA b reads
// block b's pointers and step count from a descriptor in the launch's
// __grid_constant__ parameters (CUDA >= 12.1 passes 32 KB), so blocks of
// any lengths share a launch, each with its own steps, flush, fresh table
// and overflow check (`emax`): its bytes are the one-block launch's.
// * Table entries are 16 bits: p in bits 0-11 (always in [16, 4080]) and
//   a saturating visit count in bits 12-15. The law reads the visit count
//   only through the shift above, which stops changing at a count `vcap`
//   (8 for QUAL, 2 for L3 SEQ, 1 for L1/L2 SEQ), so min(vis, vcap) is
//   exact; the wrapper derives vcap and refuses a geometry past 15.
// * Where the table and the hash fit the 227 KB of shared memory (the
//   byte and flag kinds, and the small L1 tables) it lives there, built by
//   the kernel; otherwise (L3 SEQ 8.4 MB, QUAL 1.03 MB) in device memory,
//   L2-resident, read with plain loads (a CTA's own stores are ordered by
//   __syncthreads, so L1 may serve them).
// * The law's per-step bookkeeping is an open-addressed hash of >= 2W
//   slots (key, count, delta sum) in shared memory, double-buffered by
//   bit-step parity. No global atomics. Each real lane inserts its entry
//   (atomicCAS; the lane whose CAS placed the key owns the slot), adds 1
//   to its count and later its delta to its sum, all shared atomics, whose
//   same-address conflicts the hardware resolves. (Grouping a warp's
//   lanes first with __match_any_sync and reducing each group's deltas
//   measured slower: a per-group __reduce_add_sync loops over the warp's
//   groups, a leader's sum over its group.)
// * Two barriers per bit-step:
//     phase 1: owners of step t-1 store clamp(p + sum) with the visit
//       count raised by the step's count, and clear their slot; every lane
//       inserts its step-t entry;
//     barrier;
//     phase 2: read the slot's count and the entry (p, vis), code the
//       decision, add the delta to the slot; load step t+1's entry of a
//       device table (see Lockstep::fetch);
//     barrier.
//   This equals the format's marker arithmetic: today's entry is
//   clamp(p + sum(d - MARK) + sum(MARK)) = clamp(p + sum(d)), int32
//   addition commutes, and colliding lanes store one value.
// * Loads ahead of their use: E's and D's step inputs one symbol-step
//   ahead, a device table's entry one bit-step ahead (the next entry is
//   known early: E's symbols are inputs, D's next row follows from the
//   decoded symbol before its last barrier) and D's next payload byte. (A
//   barrier does not wait for a thread's pending loads; only their use
//   does.)

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
constexpr int P_MASK = PROB_ONE - 1;  // entry bits 0-11: p
constexpr int VIS_SHIFT = PROB_BITS;  // entry bits 12-15: visit count
constexpr int EMPTY = -1;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int MAX_BLOCKS = 256;  // descriptors a launch: coder_torch's too

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

// Layout of the dynamic shared memory: [table (if in shared memory)]
// [hash keys | counts | delta sums], each hash array two buffers of 2^nsl.
__host__ __device__ inline int table_smem_bytes(int table_size) {
  return (table_size * 2 + 15) / 16 * 16;
}

__host__ __device__ inline int hash_smem_bytes(int nsl) {
  return 3 * 2 * (1 << nsl) * 4;
}

// One lane's view of the table law across bit-steps.
template <bool SMEM, bool WARM>
struct Lockstep {
  uint16_t* table;  // shared or device memory
  int *key, *cnt, *sum;
  int nsl;  // log2 of the slots in one buffer
  Geo g;
  // this bit-step (and, until phase 1 of the next, the one before)
  int b = 0, idx = 0, slot = 0, p = PROB_MAX, vis = 0, n = 0;
  int ahead = 0;  // a device table's entry for the next bit-step
  bool real = false, own = false;

  // gtable: the device table (unused where the table lives in shared
  // memory)
  __device__ void setup(unsigned char* smem, uint16_t* gtable, Geo geo,
                        int ns_log2) {
    g = geo;
    nsl = ns_log2;
    table = SMEM ? reinterpret_cast<uint16_t*>(smem) : gtable;
    key = reinterpret_cast<int*>(
        smem + (SMEM ? table_smem_bytes(g.table_size) : 0));
    cnt = key + (2 << nsl);
    sum = cnt + (2 << nsl);
    for (int i = threadIdx.x; i < (2 << nsl); i += blockDim.x) {
      key[i] = EMPTY;
      cnt[i] = 0;
      sum[i] = 0;
    }
    if (SMEM) {  // the sacrificial row pinned at PROB_MAX
      for (int i = threadIdx.x; i < g.table_size; i += blockDim.x)
        table[i] = (uint16_t)(i < g.sac_base ? PROB_INIT : PROB_MAX);
    }
    __syncthreads();
  }

  // the slot of `k` in buffer b (linear probing; at most W keys in >= 2W
  // slots); `own` is set where this call placed the key
  __device__ __forceinline__ int find(int k) {
    const unsigned m = (1u << nsl) - 1;
    unsigned h = ((unsigned)k * 2654435761u) >> (32 - nsl);
    for (;;) {
      const int old = atomicCAS(key + b + h, EMPTY, k);
      if (old == EMPTY) {
        own = true;
        return (int)h;
      }
      if (old == k) return (int)h;
      h = (h + 1) & m;
    }
  }

  // the owner of the last bit-step's slot stores its entry and clears
  // the slot (phase 1 of the next bit-step)
  __device__ __forceinline__ void commit() {
    if (own) {
      const int at = b + slot;
      const int np = clampi(p + sum[at], PROB_MIN, PROB_MAX);
      const int nv = WARM ? min(vis + n, g.vcap) : 0;
      table[idx] = (uint16_t)(np | (nv << VIS_SHIFT));
      key[at] = EMPTY;
      cnt[at] = 0;
      sum[at] = 0;
    }
    own = false;
  }

  // phase 1 of bit-step s: commit step s-1, enter this step's entry
  __device__ __forceinline__ void enter(int s, int i, bool live) {
    commit();
    b = (s & 1) << nsl;
    idx = i;
    real = live && i < g.sac_base;
    if (real) {
      slot = find(i);
      atomicAdd(cnt + b + slot, 1);
    }
  }

  // Load a device table's entry for the next bit-step `i` ahead of its
  // use, during phase 2 of this one: its last store (in phase 1 of this
  // step at the latest) is ordered before by this step's first barrier,
  // and the next commit stores this step's entries, which lie on another
  // tree level (depth >= 2, which the wrapper enforces for a device
  // table).
  __device__ __forceinline__ void fetch(int i, bool live) {
    if (!SMEM && live && i < g.sac_base) ahead = table[i];
  }

  // phase 2 (after the barrier): this step's probability
  __device__ __forceinline__ uint32_t prob() {
    if (real) {
      n = cnt[b + slot];
      const int e = SMEM ? table[idx] : ahead;
      p = e & P_MASK;
      vis = e >> VIS_SHIFT;
    } else {
      p = PROB_MAX;  // the sacrificial row never adapts
    }
    return (uint32_t)p;
  }

  // phase 2: this lane's delta into its slot
  __device__ __forceinline__ void update(bool one) {
    int d = 0;
    if (real) {
      const int r = WARM ? min(g.rate, g.rate_lo + ceil_log2(vis + 1))
                         : g.rate;
      d = one ? -(p >> r) : (PROB_ONE - p) >> r;
      // n lanes scale the delta down by 2^(ceil_log2(n) - CAP_LOG2) where
      // the format's 10-bit count field holds more than 2^CAP_LOG2: it
      // reads n < 512 as is, 512..1023 negative and 1024 as 0
      if (n > (1 << CAP_LOG2) && n < (1 << (CNT_BITS - 1)))
        d >>= 32 - __clz(n - 1) - CAP_LOG2;
    }
    if (real) atomicAdd(sum + b + slot, d);
  }
};

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

// One symbol-step's inputs of a lane.
struct StepIn {
  uint32_t sym, pos;
  bool act, rs, mf;
};

// One block's stream for Kernel E: its symbols and step inputs, its fresh
// device table (null where the table lives in shared memory) and its
// outputs.
struct EncDesc {
  const uint8_t* syms;    // [Sp, W]
  const int* poss;        // [Sp, W]; null for the byte and flag kinds
  const int* resets;      // [Sp, W]; null for the byte and flag kinds
  const int* counts;      // [W]
  const uint8_t* mflags;  // [Sp, W]; null without the match family
  uint16_t* table;        // [table_size]
  uint8_t* ebufs;         // [NC, W, CB]
  int* eptrs;             // [NC, W]
  uint32_t* low;          // [W]: the coder's final low
  int* emax;              // this block's largest chunk count
  int NC;
};

struct EncParams {
  EncDesc d[MAX_BLOCKS];
  Geo geo;
  Ctx cx;
  int W, nsl, CB;
};

template <bool SMEM, bool WARM>
__global__ void __launch_bounds__(1024, 1)
    lane_encode_kernel(const __grid_constant__ EncParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const EncDesc& desc = p.d[blockIdx.x];
  const Geo& geo = p.geo;
  const Ctx& cx = p.cx;
  const int NC = desc.NC, W = p.W, CB = p.CB, depth = cx.depth;
  uint8_t* __restrict__ ebufs = desc.ebufs;
  const int w = threadIdx.x;
  const bool live = w < W;
  Lockstep<SMEM, WARM> L;
  L.setup(smem, desc.table, geo, p.nsl);
  uint32_t low = 0, rng = 0xFFFFFFFFu;
  const int cnt = live ? desc.counts[w] : 0;
  const int Sp = NC * CHUNK_SYMS;
  // symbol-step t's inputs (none past the stream: the sacrificial row)
  auto inputs = [&](int t, StepIn* x) {
    x->sym = x->pos = 0;
    x->act = x->rs = x->mf = false;
    if (live && t < Sp) {
      const size_t at = (size_t)t * W + w;
      x->act = t < cnt;
      x->sym = desc.syms[at];
      if (desc.resets != nullptr) {
        x->rs = desc.resets[at] != 0;
        x->pos = (uint32_t)desc.poss[at];
      }
      if (desc.mflags != nullptr) x->mf = desc.mflags[at] == 1;
    }
  };
  CtxState st;
  StepIn cur, nxt;
  inputs(0, &cur);
  inputs(1, &nxt);
  // the symbol coded (0 where the step is not active) and its first entry
  uint32_t sym = cur.act ? cur.sym : 0u;
  int base = st.row(cx, cur.act, cur.rs, cur.pos, cur.mf);
  // bit j of the symbol: its table entry (its value: bit depth-1-j)
  auto entry = [&](int j) {
    return base + (int)((1u << j) | (sym >> (depth - j))) - 1;
  };
  L.fetch(entry(0), live);
  int emx = 0, s = 0, t = 0;
  for (int c = 0; c < NC; ++c) {
    uint8_t* eb = ebufs + ((size_t)c * W + w) * CB;
    int eptr = 0;
    for (int k = 0; k < CHUNK_SYMS; ++k) {
      for (int j = 0; j < depth; ++j, ++s) {
        const bool one = (sym >> (depth - 1 - j)) & 1u;
        L.enter(s, entry(j), live);
        __syncthreads();
        const uint32_t split = (rng >> PROB_BITS) * L.prob();
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
          if (live && eptr < CB) eb[eptr] = (uint8_t)(low >> 24);
          ++eptr;  // counted past CB: the caller reruns with hard buffers
          low <<= 8;
          rng <<= 8;
        }
        L.update(one);
        if (j + 1 == depth) {  // the next symbol-step: its row and symbol
          st.advance(cx, sym);
          cur = nxt;
          inputs(++t + 1, &nxt);
          sym = cur.act ? cur.sym : 0u;
          base = st.row(cx, cur.act, cur.rs, cur.pos, cur.mf);
          L.fetch(entry(0), live);
        } else {
          L.fetch(entry(j + 1), live);
        }
        __syncthreads();
      }
    }
    if (live) desc.eptrs[(size_t)c * W + w] = eptr;
    emx = max(emx, eptr);
  }
  if (live) {
    desc.low[w] = low;
    atomicMax(desc.emax, emx);
  }
}

// One block's stream for Kernel D: its payload and step inputs, its
// fresh device table (null where the table lives in shared memory) and
// its symbols.
struct DecDesc {
  const uint8_t* payload;  // [W, Lb]
  const int* lens;         // [W]
  const int* counts;       // [W]
  const int* poss;         // [Sp, W]
  const int* resets;       // [Sp, W]
  const uint8_t* mflags;   // [Sp, W], the MATCH instantiation only
  uint16_t* table;         // [table_size]
  uint8_t* syms;           // [Sp, W]
  int Lb, Sp;
};

struct DecParams {
  DecDesc d[MAX_BLOCKS];
  Geo geo;
  Ctx cx;
  int W, nsl;
};

// MATCH: a format-v5 SEQ stream with the match-context family, whose
// match-span flags `mflags` select the family's row (a separate
// instantiation, so a stream without the family runs the code it ran
// before the family existed).
template <bool SMEM, bool WARM, bool MATCH>
__global__ void __launch_bounds__(1024, 1)
    lane_decode_kernel(const __grid_constant__ DecParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DecDesc& desc = p.d[blockIdx.x];
  const Ctx& cx = p.cx;
  const int W = p.W, Lb = desc.Lb, Sp = desc.Sp;
  const int* __restrict__ poss = desc.poss;
  const int* __restrict__ resets = desc.resets;
  const uint8_t* __restrict__ mflags = desc.mflags;
  uint8_t* __restrict__ syms = desc.syms;
  const int w = threadIdx.x;
  const bool live = w < W;
  Lockstep<SMEM, WARM> L;
  L.setup(smem, desc.table, p.geo, p.nsl);
  const uint8_t* row = desc.payload + (size_t)(live ? w : 0) * Lb;
  const int len = live ? desc.lens[w] : 0;
  const int cnt = live ? desc.counts[w] : 0;
  // payload byte q of this lane; 0 past its end (read_bytes)
  auto fetch = [&](int q) -> uint32_t {
    return q < len ? row[min(q, Lb - 1)] : 0u;
  };
  int ptr = 0;
  uint32_t low = 0, rng = 0xFFFFFFFFu, code = 0;
  for (int r = 0; r < 4; ++r) code = (code << 8) | fetch(ptr++);
  uint32_t nb = fetch(ptr);  // the next byte, loaded ahead of its use
  CtxState st;
  // this symbol-step's inputs, then the next one's, loaded ahead
  auto inputs = [&](int t, bool* act, bool* rs, uint32_t* pos, bool* mf) {
    *act = *rs = *mf = false;
    *pos = 0;
    if (live && t < Sp) {
      const size_t at = (size_t)t * W + w;
      *act = t < cnt;
      *rs = resets[at] != 0;
      *pos = (uint32_t)poss[at];
      if (MATCH) *mf = mflags[at] == 1;
    }
  };
  bool act, rs, mf, nact, nrs, nmf;
  uint32_t pos, npos;
  inputs(0, &act, &rs, &pos, &mf);
  inputs(1, &nact, &nrs, &npos, &nmf);
  int base = st.row(cx, act, rs, pos, mf), node = 1, d = 0, t = 0;
  L.fetch(base, live);
  for (int s = 0; s < Sp * cx.depth; ++s) {
    L.enter(s, base + node - 1, live);
    __syncthreads();
    const uint32_t split = (rng >> PROB_BITS) * L.prob();
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
      code = (code << 8) | nb;
      nb = fetch(++ptr);
      low <<= 8;
      rng <<= 8;
    }
    L.update(one);
    node = 2 * node + one;
    if (++d == cx.depth) {  // the symbol is complete
      const uint32_t sym = act ? (uint32_t)(node - (1 << cx.depth)) : 0u;
      st.advance(cx, sym);
      if (live) syms[(size_t)t * W + w] = (uint8_t)sym;
      act = nact;
      rs = nrs;
      pos = npos;
      mf = nmf;
      inputs(++t + 1, &nact, &nrs, &npos, &nmf);
      base = st.row(cx, act, rs, pos, mf);
      node = 1;
      d = 0;
    }
    L.fetch(base + node - 1, live);
    __syncthreads();
  }
}

// One barrier of `blockDim` threads per loop step: the latency that bounds
// Kernel D's lockstep from below.
__global__ void barrier_loop_kernel(int iters, int* out) {
  int acc = threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    __syncthreads();
    acc += i;
  }
  if (acc == -1) *out = acc;
}

// Block shape and dynamic shared memory of one coder launch.
struct Shape {
  int threads, nsl, bytes;
};

// false where W lanes or the shared-memory layout do not fit one CTA
bool shape_of(int W, bool smem_table, int table_size, Shape* sh) {
  sh->threads = (W + 31) / 32 * 32;
  sh->nsl = 0;  // 2^nsl >= 2 * threads
  while ((1 << sh->nsl) < 2 * sh->threads) ++sh->nsl;
  sh->bytes = (smem_table ? table_smem_bytes(table_size) : 0) +
              hash_smem_bytes(sh->nsl);
  return W >= 1 && sh->threads <= 1024 && sh->bytes <= SMEM_LIMIT;
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch over n blocks' descriptors (an array of EncDesc / DecDesc: a
// parameter of a type in the anonymous namespace would take the entry's C
// linkage away), one CTA each. vcap: the saturating visit count, 0 without
// warm-up; smem_table: the tables live in shared memory (the descriptors'
// `table` is then unused).
int lane_encode(const void* descs, int n, int W, int table_size,
                int sac_base, int rate, int rate_lo, int vcap, int smem_table,
                int CB, int depth, int kind, int num_ctx, int k0, int k1,
                int k2, int k3, cudaStream_t stream) {
  Shape sh;
  if (n < 1 || n > MAX_BLOCKS || !shape_of(W, smem_table, table_size, &sh))
    return (int)cudaErrorInvalidValue;
  EncParams p = {};
  for (int i = 0; i < n; ++i) p.d[i] = static_cast<const EncDesc*>(descs)[i];
  p.geo = Geo{table_size, sac_base, rate, rate_lo, vcap};
  p.cx = Ctx{kind, depth, num_ctx, k0, k1, k2, k3};
  p.W = W;
  p.nsl = sh.nsl;
  p.CB = CB;
  auto go = [&](auto kern) -> int {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<n, sh.threads, sh.bytes, stream>>>(p);
    return (int)cudaGetLastError();
  };
  if (smem_table)
    return vcap ? go(lane_encode_kernel<true, true>)
                : go(lane_encode_kernel<true, false>);
  return vcap ? go(lane_encode_kernel<false, true>)
              : go(lane_encode_kernel<false, false>);
}

// match: the descriptors carry a format-v5 SEQ stream's [Sp, W] match-span
// flags (the match-context family's instantiation).
int lane_decode(const void* descs, int n, int W, int table_size,
                int sac_base, int rate, int rate_lo, int vcap, int smem_table,
                int depth, int kind, int num_ctx, int k0, int k1, int k2,
                int k3, int match, cudaStream_t stream) {
  Shape sh;
  if (n < 1 || n > MAX_BLOCKS || !shape_of(W, smem_table, table_size, &sh))
    return (int)cudaErrorInvalidValue;
  DecParams p = {};
  for (int i = 0; i < n; ++i) p.d[i] = static_cast<const DecDesc*>(descs)[i];
  p.geo = Geo{table_size, sac_base, rate, rate_lo, vcap};
  p.cx = Ctx{kind, depth, num_ctx, k0, k1, k2, k3};
  p.W = W;
  p.nsl = sh.nsl;
  auto go = [&](auto kern) -> int {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<n, sh.threads, sh.bytes, stream>>>(p);
    return (int)cudaGetLastError();
  };
  // the match family's instantiation where the flags are given
  auto pick = [&](auto plain, auto fam) {
    return match ? go(fam) : go(plain);
  };
  if (smem_table)
    return vcap ? pick(lane_decode_kernel<true, true, false>,
                       lane_decode_kernel<true, true, true>)
                : pick(lane_decode_kernel<true, false, false>,
                       lane_decode_kernel<true, false, true>);
  return vcap ? pick(lane_decode_kernel<false, true, false>,
                     lane_decode_kernel<false, true, true>)
              : pick(lane_decode_kernel<false, false, false>,
                     lane_decode_kernel<false, false, true>);
}

// `iters` barriers of `threads` threads in one CTA (a measurement aid:
// chip_smoke.py times it for Kernel D's lockstep bound).
int barrier_loop(int iters, int threads, int* out, cudaStream_t stream) {
  barrier_loop_kernel<<<1, threads, 0, stream>>>(iters, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
