// Lockstep lane decoder: Kernel D (lane_decode).
//
// Replaces: slimfastq_tpu/ops/streams_jax.py `_build_decode` and
// `_build_decode_ll` (the decode coder scan), with and without
// `with_mflag` (format v5: a SEQ stream whose steps inside a match span
// code in the match-context family). Those are plain XLA programs, not
// Pallas, but they carry the whole coding loop; in eager PyTorch the same
// loop would be ~30 tensor ops per bit-step, i.e. over a million launches
// per stream per 64k-record block. The encode is Kernel E, encode.cu.
//
// D builds each symbol-step's context row online from the symbols it
// decodes, with the per-lane state Kernel E builds its rows with
// (CtxState in ctx.cuh: the reference's _ctx_step / _ctx_advance), so E
// and D cannot drift apart. Bit j of a symbol takes entry
// row + ((1 << j) | (sym >> (depth - j))) - 1; a step at or past its
// lane's count decodes symbol 0 in the sacrificial row num_ctx.
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
// Bound on the H100: D is a serial chain of bit-steps on one SM (QUAL at
// the 64k-record block: 6,400 steps x 6 bits = 38,400 bit-steps). Its law
// couples the lanes at every bit-step (the next decision's entry follows
// from the symbol this one decodes), so its floor is bit-steps x one
// 1,024-thread barrier (barrier_loop below measures it). At W = 1024 it
// runs far above that floor, bound by issuing ~200 instructions per lane
// and bit-step for 32 warps on the SM's 4 schedulers. A block's seven
// streams run as seven CTAs on their own CUDA streams, so a block costs its
// longest chain, not the sum; a window's B blocks run as B CTAs of one
// launch side by side (one SM each), so its bound is one block's chain, not
// B of them. Next: QUAL's table in a cluster's distributed shared memory,
// fewer instructions a bit-step, W > 1024.
//
// Design: one CTA per stream of one block, one thread per lane (W <= 1024,
// rounded up to whole warps; the extra threads take part in barriers
// only). A launch decodes one stream of each block of a window (also
// replacing parallel/mesh.py's vmap over blocks, mesh=None): CTA b reads
// block b's pointers and step count from a descriptor in the launch's
// __grid_constant__ parameters (CUDA >= 12.1 passes 32 KB), so blocks of
// any lengths share a launch, each with its own steps and fresh table.
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
//     phase 2: read the slot's count and the entry (p, vis), decode the
//       decision, add the delta to the slot; load step t+1's entry of a
//       device table (see Lockstep::fetch);
//     barrier.
//   This equals the format's marker arithmetic: today's entry is
//   clamp(p + sum(d - MARK) + sum(MARK)) = clamp(p + sum(d)), int32
//   addition commutes, and colliding lanes store one value.
// * Loads ahead of their use: the step inputs one symbol-step ahead, a
//   device table's entry one bit-step ahead (the next row follows from the
//   decoded symbol before the step's last barrier) and the next payload
//   byte. (A barrier does not wait for a thread's pending loads; only
//   their use does.)

#include "ctx.cuh"

namespace {

constexpr int EMPTY = -1;

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
    if (real) atomicAdd(sum + b + slot, law_delta<WARM>(g, p, vis, n, one));
  }
};

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

// One launch over n blocks' descriptors (an array of DecDesc: a
// parameter of a type in the anonymous namespace would take the entry's C
// linkage away), one CTA each. vcap: the saturating visit count, 0 without
// warm-up; smem_table: the tables live in shared memory (the descriptors'
// `table` is then unused).
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
