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
// Bound on the H100: D is a serial chain of bit-steps (QUAL at the
// 64k-record block: 6,400 steps x 6 bits = 38,400 bit-steps). Its law
// couples the lanes at every bit-step (the next decision's entry follows
// from the symbol this one decodes), so its floor is bit-steps x one
// barrier of the lanes (barrier_loop below measures the CTA's and the
// cluster's). A block's seven streams run on their own CUDA streams, so a
// block costs its longest chain, not the sum; a window's B blocks run side
// by side in one launch, so its bound is one block's chain, not B of them.
// At W = 1024 in one CTA a bit-step is bound by its 32 warps' issue on one
// SM; a W = 64 stream by the latency of its chain (the shared atomics
// before each barrier among it).
//
// Design: one thread per lane, the lanes of a block's stream in one CTA
// or, for a SEQ stream of 1,024 lanes, over a thread block cluster of C
// CTAs (C a power of two <= 8, lane w in CTA w / T of T threads; the extra
// threads take part in barriers only). coder_torch.decode_shape derives
// C, T, where the table lives and every region's bytes from the geometry,
// W and the window's B; the entry below refuses a shape that does not hold
// and never launches another. A launch decodes one stream of each block of
// a window (also replacing parallel/mesh.py's vmap over blocks,
// mesh=None): CTA (or cluster) b reads block b's pointers and step count
// from a descriptor in the launch's __grid_constant__ parameters (CUDA >=
// 12.1 passes 32 KB), so blocks of any lengths share a launch, each with
// its own steps and fresh table.
// * Table entries are 16 bits: p in bits 0-11 (always in [16, 4080]) and
//   a saturating visit count in bits 12-15. The law reads the visit count
//   only through the shift above, which stops changing at a count `vcap`
//   (8 for QUAL, 2 for L3 SEQ, 1 for L1/L2 SEQ), so min(vis, vcap) is
//   exact; the wrapper derives vcap and refuses a geometry past 15.
// * Where the table and the hash fit the 227 KB of shared memory (the
//   byte and flag kinds, the L1 tables and L2's SEQ) it lives there, built
//   by the kernel; otherwise (L3 SEQ 8.4 MB, QUAL 1.03 MB) in device
//   memory, L2-resident (read past L1 where a cluster shares it).
// * The law's per-step bookkeeping is an open-addressed hash of >= 2W
//   slots (key; count and ones, 16 bits each) in shared memory, three
//   buffers rotated by bit-step mod 3; in a cluster entry e's slots live in
//   CTA e mod C, which the others reach as distributed shared memory
//   (map_shared_rank; remote shared atomics). No global atomics. A real
//   lane probes its entry's slot (atomicCAS; the lane whose CAS placed the
//   key owns the slot) as soon as it knows the entry, and after its decode
//   adds 1 | one << 16 to the slot. The owner then stores the entry as the
//   format's law leaves it: the decode does not read the count, every
//   lane on an entry read the same p and visits, and its delta takes one
//   of two values by its decision, so the deltas sum to n1 * d(one) +
//   (n - n1) * d(zero) with n the slot's count and n1 its ones.
// * One barrier a bit-step. Between the barriers ending bit-steps s-1 and
//   s: the owners of step s-1 commit (store clamp(p + sum) with the visit
//   count raised by n) and clear their slots; every lane decodes step s
//   with the entry it loaded ahead and counts itself into its slot; then
//   probes its step s+1 slot in the next buffer and loads that entry
//   ahead. This is exact because:
//   - step s's counts are complete at the barrier that ends it, where its
//     owners read them in the next interval;
//   - a buffer is cleared (step s-1's, in interval s) one interval before
//     it is probed again (step s+2's, at the end of interval s+1), hence
//     three;
//   - the entries step s-1 commits lie on another tree level than those
//     step s reads (consecutive bit-steps are consecutive levels, depth
//     >= 2), and than those step s+1 loads ahead where depth >= 3 (levels
//     j-1 and j+1 mod depth), so no lane reads an entry while it is
//     stored; the stores of steps before s-1 are ordered by barriers.
//   Where that fails a second barrier follows the commit (`two`): depth 1
//   (the flag kind, whose steps share one level) and a depth-2 table in
//   device memory (SEQ, whose entry is loaded one bit-step ahead, and
//   step s+1's level is step s-1's). A depth-2 table in shared memory is
//   read at its use, after the barrier, and keeps one barrier.
//   This equals the format's marker arithmetic: today's entry is
//   clamp(p + sum(d - MARK) + sum(MARK)) = clamp(p + sum(d)), int32
//   addition commutes, and colliding lanes store one value.
// * Only SEQ's 1,024 lanes (two barriers a bit-step, a device table) span
//   a cluster: there the card measured 8 CTAs of 128 threads faster than
//   one CTA on 100 bp reads (on 16.5 kb reads, whose lanes rarely share an
//   entry, one CTA measured faster; the shape does not see the reads);
//   elsewhere the cluster barrier (0.42 us against the CTA's 0.039 us on
//   the H100) costs more than it saves. (Measured and not
//   kept: L3 QUAL over 8 CTAs with its table split over their shared
//   memory; merging a warp's lanes on one entry, by __all_sync or by
//   __match_any_sync, before their atomics; loading both children of a
//   step's node one bit-step earlier from a device table.)
// * The payload: each lane reads its bytes from aligned 4-byte words in
//   registers, two words loaded ahead of the one in use, so no renorm round
//   waits on device memory; the step inputs come one symbol-step ahead and
//   are read only at their use. (A barrier does not wait for a thread's
//   pending loads into registers; only their use does.)

#include <cooperative_groups.h>

#include "ctx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int EMPTY = -1;
constexpr int NBUF = 3;          // hash buffers, rotated by bit-step mod 3
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// Layout of a CTA's dynamic shared memory: [the table, where it lives in
// shared memory][hash keys | counts], each hash array NBUF buffers of
// 2^nsl slots.
__host__ __device__ inline int table_smem_bytes(int entries) {
  return (entries * 2 + 15) / 16 * 16;
}

__host__ __device__ inline int hash_smem_bytes(int nsl) {
  return 2 * NBUF * (1 << nsl) * 4;
}

// One lane's payload bytes through aligned 4-byte words in registers, two
// loaded ahead of the one in use: byte q is row[q] below min(len, Lb),
// row[Lb - 1] up to len, and 0 past len (the plain version's read). A word
// is loaded only where it holds one of the lane's bytes, so it lies inside
// the payload's allocation.
struct Bytes {
  uintptr_t a, lo, hi, end, k;  // next byte; row; row + min(len, Lb);
                                // row + len; the word index of w0
  uint32_t w0, w1, w2, last;

  __device__ __forceinline__ uint32_t word(uintptr_t i) const {
    const uintptr_t at = i << 2;
    return at < hi && at + 4 > lo
               ? __ldg(reinterpret_cast<const unsigned int*>(at))
               : 0u;
  }

  __device__ void init(const uint8_t* row, int len, int Lb) {
    lo = a = reinterpret_cast<uintptr_t>(row);
    hi = lo + (uintptr_t)max(min(len, Lb), 0);
    end = lo + (uintptr_t)max(len, 0);
    last = len > Lb ? row[Lb - 1] : 0u;
    k = lo >> 2;
    w0 = word(k);
    w1 = word(k + 1);
    w2 = word(k + 2);
  }

  __device__ __forceinline__ uint32_t next() {
    if ((a >> 2) != k) {
      w0 = w1;
      w1 = w2;
      ++k;
      w2 = word(k + 2);
    }
    const uint32_t v =
        a < hi ? (w0 >> ((a & 3) * 8)) & 0xFFu : (a < end ? last : 0u);
    ++a;
    return v;
  }
};

template <bool CL>
__device__ __forceinline__ void sync_all() {
  if (CL)
    cg::this_cluster().sync();  // release / acquire at cluster scope
  else
    __syncthreads();
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
  const uint8_t* mflags;   // [Sp, W], a format-v5 SEQ stream's only
  uint16_t* table;         // [table_size]
  uint8_t* syms;           // [Sp, W]
  int Lb, Sp;
};

struct DecParams {
  DecDesc d[MAX_BLOCKS];
  Geo geo;
  Ctx cx;
  int W, nsl, lc;  // lanes; log2 of a buffer's slots; log2 of C
  int two;         // a second barrier after the commit
  int ahead;       // each entry loaded one bit-step ahead
  int match;       // the descriptors carry match-span flags
};

// SMEM: the table lives in the CTA's shared memory (one CTA a block); CL:
// the lanes span a cluster, the table in device memory; WARM: the geometry
// counts visits.
template <bool SMEM, bool CL, bool WARM>
__global__ void __launch_bounds__(CL ? 512 : 1024, 1)
    lane_decode_kernel(const __grid_constant__ DecParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lc = CL ? p.lc : 0;
  const int rank = CL ? (int)cg::this_cluster().block_rank() : 0;
  const DecDesc& desc = p.d[blockIdx.x >> lc];
  const Ctx& cx = p.cx;
  const Geo& g = p.geo;
  const int W = p.W, Lb = desc.Lb, Sp = desc.Sp, NS = 1 << p.nsl;
  static_assert(!(SMEM && CL), "a cluster's table lives in device memory");
  const int hoff = SMEM ? table_smem_bytes(p.geo.table_size) : 0;
  const int w = rank * (int)blockDim.x + (int)threadIdx.x;
  const bool live = w < W;
  const int* __restrict__ poss = desc.poss;
  const int* __restrict__ resets = desc.resets;
  const uint8_t* __restrict__ mflags = desc.mflags;
  uint8_t* __restrict__ syms = desc.syms;
  uint16_t* gtab = desc.table;
  uint16_t* const table = SMEM ? reinterpret_cast<uint16_t*>(smem) : gtab;
  {  // this CTA's hash (and table), fresh
    int* h = reinterpret_cast<int*>(smem + hoff);
    for (int i = threadIdx.x; i < 2 * NBUF * NS; i += blockDim.x)
      h[i] = i < NBUF * NS ? EMPTY : 0;
    if (SMEM) {  // the sacrificial row pinned at PROB_MAX
      for (int i = threadIdx.x; i < g.table_size; i += blockDim.x)
        table[i] = (uint16_t)(i < g.sac_base ? PROB_INIT : PROB_MAX);
    }
  }
  // every CTA of the cluster set up before any reaches its shared memory
  sync_all<CL>();

  // entry e's keys in buffer bf (its counts NBUF * NS on), in the shared
  // memory of its CTA, e mod C
  auto keys = [&](int e, int bf) -> int* {
    const unsigned r = (unsigned)(e & ((1 << lc) - 1));
    unsigned char* home =
        CL ? cg::this_cluster().map_shared_rank(smem, r) : smem;
    return reinterpret_cast<int*>(home + hoff) + bf * NS;
  };
  // the table's entries; a cluster's CTAs reach the device table past
  // their L1s
  auto tload = [&](int e) -> int {
    return CL ? (int)__ldcg(table + e) : (int)table[e];
  };
  auto tstore = [&](int e, int v) {
    if (CL)
      __stcg(table + e, (unsigned short)v);
    else
      table[e] = (uint16_t)v;
  };
  const unsigned hmask = (unsigned)NS - 1;

  // this bit-step's entry and its slot probe (issued the interval before,
  // resolved after the decode)
  int ce = 0, cahead = 0, cold = EMPTY;
  unsigned ch = 0;
  bool creal = false;
  int* ckp = nullptr;
  // the last bit-step's slot and entry, until its commit
  int pe = 0, pslot = 0, pbuf = 0, pp = 0, pvis = 0;
  bool pown = false;
  // the entry of the next bit-step: loaded ahead, its slot probed in
  // buffer bf
  auto enter = [&](int e, int bf) {
    ce = e;
    creal = live && e < g.sac_base;
    if (creal) {
      if (p.ahead) cahead = tload(e);
      ckp = keys(e, bf);
      ch = ((unsigned)e * 2654435761u) >> (32 - p.nsl);
      cold = atomicCAS(ckp + ch, EMPTY, e);
    }
  };

  Bytes in;
  in.init(desc.payload + (size_t)(live ? w : 0) * Lb, live ? desc.lens[w] : 0,
          Lb);
  const int cnt = live ? desc.counts[w] : 0;
  uint32_t low = 0, rng = 0xFFFFFFFFu, code = 0;
  for (int r = 0; r < 4; ++r) code = (code << 8) | in.next();
  CtxState st;
  // a symbol-step's inputs as loaded (read at their use: a compare right
  // after the load would wait on it); the byte and flag kinds read none
  struct Inputs {
    int rs = 0, pos = 0, mf = 0;
  };
  auto inputs = [&](int t, Inputs* x) {
    if (live && t < Sp && cx.kind <= SEQ) {
      const size_t at = (size_t)t * W + w;
      x->rs = resets[at];
      x->pos = poss[at];
      if (p.match) x->mf = mflags[at];
    }
  };
  auto row = [&](int t, const Inputs& x) {
    return st.row(cx, t < cnt, x.rs != 0, (uint32_t)x.pos, x.mf == 1);
  };
  // this symbol-step's inputs and the next one's, loaded ahead
  Inputs cur, nxt;
  inputs(0, &cur);
  inputs(1, &nxt);
  int base = row(0, cur), node = 1, d = 0, t = 0;
  enter(base, 0);
  sync_all<CL>();
  const int S = Sp * cx.depth;
  for (int s = 0, bf = 0; s < S; ++s) {
    if (pown) {  // commit bit-step s-1 and clear its slot
      int* ks = keys(pe, pbuf) + pslot;
      const int c = ks[NBUF * NS];
      const int n = c & 0xFFFF, n1 = c >> 16;
      const int sum = n1 * law_delta<WARM>(g, pp, pvis, n, true) +
                      (n - n1) * law_delta<WARM>(g, pp, pvis, n, false);
      const int nv = WARM ? min(pvis + n, g.vcap) : 0;
      tstore(pe, clampi(pp + sum, PROB_MIN, PROB_MAX) | (nv << VIS_SHIFT));
      ks[0] = EMPTY;
      ks[NBUF * NS] = 0;
      pown = false;
    }
    if (p.two) sync_all<CL>();
    int prob = PROB_MAX, vis = 0;
    if (creal) {
      const int e = p.ahead ? cahead : tload(ce);
      prob = e & P_MASK;
      vis = e >> VIS_SHIFT;
    }
    const uint32_t split = (rng >> PROB_BITS) * (uint32_t)prob;
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
      code = (code << 8) | in.next();
      low <<= 8;
      rng <<= 8;
    }
    // the lane counts itself and its decision into its slot: count in bits
    // 0-15, ones in bits 16-31 (at most 1,024 each)
    if (creal) {
      while (cold != EMPTY && cold != ce) {
        ch = (ch + 1) & hmask;
        cold = atomicCAS(ckp + ch, EMPTY, ce);
      }
      pown = cold == EMPTY;
      atomicAdd(ckp + NBUF * NS + ch, 1 | ((int)one << 16));
    }
    pe = ce;
    pslot = (int)ch;
    pbuf = bf;
    pp = prob;
    pvis = vis;
    node = 2 * node + one;
    if (++d == cx.depth) {  // the symbol is complete
      const uint32_t sym = t < cnt ? (uint32_t)(node - (1 << cx.depth)) : 0u;
      st.advance(cx, sym);
      if (live) syms[(size_t)t * W + w] = (uint8_t)sym;
      cur = nxt;
      inputs(++t + 1, &nxt);
      base = row(t, cur);
      node = 1;
      d = 0;
    }
    bf = bf == NBUF - 1 ? 0 : bf + 1;
    if (s + 1 < S) enter(base + node - 1, bf);
    sync_all<CL>();
  }
}

// One barrier of `blockDim` threads (of every CTA of the cluster, CL) per
// loop step: the latency that bounds Kernel D's lockstep from below.
template <bool CL>
__global__ void barrier_loop_kernel(int iters, int* out) {
  int acc = threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    sync_all<CL>();
    acc += i;
  }
  if (acc == -1) *out = acc;
}

// a launch of `ctas` CTAs of `threads`, in clusters of `cluster` where
// that is above 1
template <typename Kern, typename... Args>
cudaError_t launch_clusters(Kern kern, int ctas, int threads, int cluster,
                            int bytes, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch over n blocks' descriptors (an array of DecDesc: a
// parameter of a type in the anonymous namespace would take the entry's C
// linkage away), one cluster of `cluster` CTAs of `threads` each a block
// (one CTA where cluster is 1), in the shape coder_torch.decode_shape
// derived: nsl, log2 of a hash buffer's slots; smem_table, the table in
// the CTA's shared memory (one CTA a block; else the descriptors' device
// tables); two, a second barrier a bit-step; bytes, a CTA's dynamic shared
// memory. vcap: the saturating visit count, 0 without warm-up. match: the
// descriptors carry a format-v5 SEQ stream's [Sp, W] match-span flags. A
// shape that does not hold is refused (cudaErrorInvalidValue), as is a
// launch the card refuses; nothing else is launched in its place.
int lane_decode(const void* descs, int n, int W, int table_size,
                int sac_base, int rate, int rate_lo, int vcap, int depth,
                int kind, int num_ctx, int k0, int k1, int k2, int k3,
                int match, int cluster, int threads, int nsl, int smem_table,
                int two, int bytes, cudaStream_t stream) {
  int lc = 0;
  while ((1 << lc) < cluster) ++lc;
  const int lanes = (W + 31) / 32 * 32;
  const bool ok =
      n >= 1 && n <= MAX_BLOCKS && W >= 1 && W <= 1024 && cluster >= 1 &&
      cluster <= MAX_CLUSTER && (1 << lc) == cluster && threads >= 32 &&
      threads <= (cluster > 1 ? 512 : 1024) && threads % 32 == 0 &&
      threads * cluster >= W && nsl >= 1 && nsl <= 16 &&
      (1 << nsl) >= 2 * lanes && depth >= 1 &&
      (smem_table ? cluster == 1 : depth >= 2) &&
      bytes == (smem_table ? table_smem_bytes(table_size) : 0) +
                   hash_smem_bytes(nsl) &&
      bytes <= SMEM_LIMIT &&
      (two || !(depth == 1 || (depth == 2 && !smem_table)));
  if (!ok) return (int)cudaErrorInvalidValue;
  DecParams p = {};
  for (int i = 0; i < n; ++i) p.d[i] = static_cast<const DecDesc*>(descs)[i];
  p.geo = Geo{table_size, sac_base, rate, rate_lo, vcap};
  p.cx = Ctx{kind, depth, num_ctx, k0, k1, k2, k3};
  p.W = W;
  p.nsl = nsl;
  p.lc = lc;
  p.two = two;
  p.ahead = depth >= 3 || !smem_table;
  p.match = match;
  auto go = [&](auto kern) -> int {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    e = launch_clusters(kern, n * cluster, threads, cluster, bytes, stream,
                        p);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  };
  if (smem_table)
    return vcap ? go(lane_decode_kernel<true, false, true>)
                : go(lane_decode_kernel<true, false, false>);
  if (cluster > 1)
    return vcap ? go(lane_decode_kernel<false, true, true>)
                : go(lane_decode_kernel<false, true, false>);
  return vcap ? go(lane_decode_kernel<false, false, true>)
              : go(lane_decode_kernel<false, false, false>);
}

// `iters` barriers of `threads` threads in one CTA, or of a cluster of
// `cluster` such CTAs (a measurement aid: chip_smoke.py times both for
// Kernel D's lockstep bound).
int barrier_loop(int iters, int threads, int cluster, int* out,
                 cudaStream_t stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cluster > 1 ? launch_clusters(barrier_loop_kernel<true>, cluster,
                                    threads, cluster, 0, stream, iters, out)
                  : launch_clusters(barrier_loop_kernel<false>, 1, threads, 1,
                                    0, stream, iters, out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
