// Lane decoder: Kernel D (lane_decode), synchronised once a symbol-step.
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
// The order this kernel runs, one synchronisation a symbol-step: each lane
// decodes all `depth` bits of its symbol from the table as the last
// symbol-step left it and counts each bit and its decision at its entry;
// barrier; every lane on an entry stores the value the law leaves there;
// barrier; the next symbol-step. It is exact because the tree's levels
// never share an entry: bit j of symbol-step t reads and updates only
// entry row + node - 1 with node in [2^j, 2^(j+1)), and rows are disjoint
// ranges of 2^depth - 1 entries, so an entry's level is fixed by the entry.
// Hence in the format's order (bit-step by bit-step), the entries
// bit-step (t, j) reads were last changed at (t - 1, j) or earlier, never
// by another bit of symbol-step t in any lane; and the lanes on an entry
// at (t, j) are exactly the lanes whose symbol-step t touches that entry.
// So reading every level from the table as symbol-step t - 1 left it, and
// committing each entry from its count, ones and the value it read, gives
// every entry and every decision of the bit-step order, for every kind and
// depth. At depth 1 (the flag kind) a symbol-step is one bit-step, and the
// order is the lockstep one with two barriers, as before. The commit is
// the format's marker arithmetic: clamp(p + sum(d - MARK) + sum(MARK)) =
// clamp(p + sum(d)); int32 addition commutes, every lane on an entry read
// the same p and visits, and its delta takes one of two values by its
// decision, so each stores clamp(p + n1 * d(1) + (n - n1) * d(0)) with the
// visit count raised by n: one value, whichever lane's store lands.
//
// Bound on the H100: the symbol-steps are a serial chain (QUAL at the
// 64k-record block: 6,400 symbol-steps of 6 bits), each at least two
// barriers (barrier_loop below measures the CTA's and the cluster's) and
// `depth` dependent decisions of the lane coder (E's lane coder, which
// runs the same arithmetic without the law, measures one), so the floor is
// the larger of symbol-steps x 2 barriers and bit-steps x one decision.
// (The lockstep order it replaces was bit-steps x one barrier.) A block's
// seven streams run on their own CUDA streams, so a block costs its
// longest chain; a window's B blocks run side by side in one launch.
//
// Design: one thread per lane, the lanes of a block's stream in one CTA
// or over a thread block cluster of C CTAs (C a power of two <= 8, lane w
// in CTA w / T of T threads; the extra threads take part in barriers
// only): a stream whose table lives in device memory, beside 256 lanes or
// more (QUAL, SEQ), takes the cluster, since one SM's path to L2 bounds
// its counters' traffic: the card measured it about twice as fast as one
// CTA for SEQ at every read length from 100 bases to 16.5 kb. Up to 4,096
// lanes: such a stream keeps one lane a thread over a cluster of CTAs of
// at most 512 threads; a stream whose table lives in shared memory stays
// in its one CTA of at most 1,024 threads, two or four lanes a thread
// past 1,024 (each thread's lanes in registers, or spilled: ptxas says).
// coder_torch.decode_shape derives C, T and where the table lives from
// the geometry, W and the window's B; the entry below refuses a shape
// that does not hold and never launches another. A launch decodes one
// stream of each block of a window (also replacing parallel/mesh.py's vmap
// over blocks, mesh=None): CTA (or cluster) b reads block b's pointers and
// step count from a descriptor in the launch's __grid_constant__
// parameters (CUDA >= 12.1 passes 32 KB), so blocks of any lengths share a
// launch, each with its own steps, fresh table and zeroed counters.
// * Table entries hold p in bits 0-11 (always in [16, 4080]) and a
//   saturating visit count from bit 12. The law reads the visit count only
//   through the shift above, which stops changing at a count `vcap` (8 for
//   QUAL, 2 for L3 SEQ, 1 for L1/L2 SEQ), so min(vis, vcap) is exact. An
//   entry is 16 bits where vcap fits 4 bits (every built-in level) and 32
//   bits where it does not (caps 16 to 512, e.g. rate 7 / rate_lo 2, or
//   14 / 1): the entry type E is a template argument, and the 32-bit form
//   is instantiated only where the geometry warms up (QUAL and SEQ). A
//   32-bit entry keeps D at one load a node; shared memory holds half as
//   many, and a padded SEQ row is one 16-byte load in place of 8 bytes.
// * Where the table fits the 227 KB of shared memory (the byte and flag
//   kinds, the L1 tables and L2's SEQ) it lives there, built by the
//   kernel; otherwise (L3 SEQ 8.4 MB, QUAL 1.03 MB) in device memory,
//   L2-resident (read past L1 where a cluster shares it), as is a depth-1
//   table past shared memory (the flag kind past 16 history bits). A
//   depth-2 device table (SEQ) is laid out in rows padded to 4 entries, so
//   a lane loads its row's three entries in one load at the symbol's start.
// * The law's counts: one int32 an entry of the unpadded table (count in
//   bits 0-15, ones in bits 16-31) in device memory, 16.8 MB for L3 SEQ,
//   so its table and counters (28 MB) stay in the 50 MB L2 on long reads.
//   A lane adds its marks to its entries' counters with reductions whose
//   result it never awaits (no slot to claim, no hash); after the first
//   barrier every lane on an entry reads its counter and stores the one
//   value the law leaves; after the second each lane subtracts its marks
//   again, which clears every counter by the next symbol-step's first
//   barrier whatever the order of the adds and subtracts that meet there.
// * The payload: each lane reads its bytes from aligned 4-byte words in
//   registers, two words loaded ahead of the one in use, so no renorm round
//   waits on device memory; the step inputs come one symbol-step ahead and
//   are read only at their use. (A barrier does not wait for a thread's
//   pending loads into registers; only their use does.)
// * Past REG_LANES (4,096) lanes a thread no longer holds its lanes in
//   registers: the loop form keeps each lane's coder, payload position,
//   context state and its symbol's reads in device memory (LaneState) and
//   each thread of a cluster of 8 CTAs of up to 1,024 threads walks
//   its lanes (lane r T + t + i C T on thread t of CTA r, i = 0, 1, ...)
//   in each phase of a symbol-step: take out its lane's last marks and
//   decode and count, barrier, commit, barrier. Its table lives in device
//   memory whatever its size (a table that would fit shared memory too:
//   every CTA of the cluster reads and commits the one copy), and its
//   counters take 64 bits (count in bits 0-31, ones in 32-63) from
//   WIDE_LANES (65,536) lanes on, where 16 bits no longer hold a count.
//   The cluster's CTAs are scheduled together (the hardware's guarantee),
//   so its barrier cannot wait on a CTA that never runs, whatever else
//   the card runs beside it.
// * Measured on the H100 and not kept (tools/decode_streams.py beside
//   probes): the law in a shared-memory hash, one a tree level, whose
//   lanes claim their slots by CAS (QUAL 53.4 ms, IDD 37.3: the atomics
//   cost more than the barriers saved); merging a warp's lanes on an entry
//   (__match_any_sync) before one add; one owner a counter (an add that
//   returns) committing for the others; QUAL's row padded to 64 entries and
//   loaded whole (no gain); QUAL in one CTA (79 ms: its counters' traffic
//   through one SM); the counters in two halves by symbol-step parity,
//   each cleared by stores (QUAL about 5% faster, the long block's 20%,
//   but SEQ's padded halves, 56 MB with its table, passed the L2: the long
//   block's SEQ took 9.7 s over the cluster against 3.1 now); the
//   subtracts issued after the next symbol's decode (no gain).

#include <cooperative_groups.h>

#include <type_traits>

#include "ctx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_DEPTH = 8;     // tree levels a symbol (the byte kind's 8)
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int REG_LANES = 4096;  // coder_torch.REG_LANES
constexpr int WIDE_LANES = 1 << 16;  // coder_torch.WIDE_LANES
constexpr int MAX_PER_THREAD = 4;  // lanes a thread (a table in smem)

// A CTA's dynamic shared memory: the table, where it lives there.
__host__ __device__ inline int table_smem_bytes(int entries, int ebytes) {
  return (entries * ebytes + 15) / 16 * 16;
}

// A padded row of a depth-2 device table, its 4 entries of type E loaded
// whole: V the load, `at` node nd's entry (nd 1, 2 or 3)
template <typename E>
struct PadRow;

template <>
struct PadRow<uint16_t> {
  using V = uint2;
  static __device__ __forceinline__ V none() {
    return make_uint2(PROB_MAX | (PROB_MAX << 16), PROB_MAX);
  }
  static __device__ __forceinline__ int at(const V& r, int nd) {
    return (int)(nd == 1 ? r.x & 0xFFFFu : nd == 2 ? r.x >> 16 : r.y & 0xFFFFu);
  }
};

template <>
struct PadRow<uint32_t> {
  using V = uint4;
  static __device__ __forceinline__ V none() {
    return make_uint4(PROB_MAX, PROB_MAX, PROB_MAX, PROB_MAX);
  }
  static __device__ __forceinline__ int at(const V& r, int nd) {
    return (int)(nd == 1 ? r.x : nd == 2 ? r.y : r.z);
  }
};

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
// fresh device table (null where the table lives in shared memory), the
// law's zeroed counters and its symbols.
struct DecDesc {
  const uint8_t* payload;  // [W, Lb]
  const int* lens;         // [W]
  const int* counts;       // [W]
  const int* poss;         // [Sp, W]
  const int* resets;       // [Sp, W]
  const uint8_t* mflags;   // [Sp, W], a format-v5 SEQ stream's only
  void* table;             // [table_size] entries of type E (padded
                           // where PAD)
  int* tally;              // [table_size] (unpadded), zero; 64-bit
                           // counters from WIDE_LANES lanes on
  uint8_t* syms;           // [Sp, W]
  void* state;             // [W] LaneState past REG_LANES, else null
  int Lb, Sp;
};

struct DecParams {
  DecDesc d[MAX_BLOCKS];
  Geo geo;
  Ctx cx;
  int W, lc;  // lanes; log2 of C
  int match;  // the descriptors carry match-span flags
};

// SMEM: the table lives in the CTA's shared memory (one CTA a block);
// CL: the lanes span a cluster, the table in device memory; WARM: the
// geometry counts visits; PAD: a depth-2 device table (SEQ) whose rows are
// padded to 4 entries, each loaded whole at its symbol's start; K: lanes a
// thread (lane (rank K + i) T + t on thread t of CTA rank, i < K), 2 or 4
// only for a table in shared memory past 1,024 lanes: each phase of a
// symbol-step runs over the thread's lanes in turn, so its lanes keep the
// order they would keep on K threads. E: the table entry, uint16_t or (a
// visit cap past 15, WARM only) uint32_t.
template <bool SMEM, bool CL, bool WARM, bool PAD, int K, typename E>
__global__ void __launch_bounds__(CL ? 512 : 1024, 1)
    lane_decode_kernel(const __grid_constant__ DecParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lc = CL ? p.lc : 0;
  const int rank = CL ? (int)cg::this_cluster().block_rank() : 0;
  const DecDesc& desc = p.d[blockIdx.x >> lc];
  const Ctx& cx = p.cx;
  const Geo& g = p.geo;
  const int W = p.W, Lb = desc.Lb, Sp = desc.Sp;
  const int depth = PAD ? 2 : cx.depth;
  static_assert(!(SMEM && CL), "a cluster's table lives in device memory");
  static_assert(!(SMEM && PAD), "padded rows in device memory only");
  static_assert(K == 1 || (SMEM && !CL), "lanes a thread: one CTA, smem");
  static_assert(sizeof(E) == 2 || WARM, "32-bit entries warm up");
  using Row = PadRow<E>;
  const int* __restrict__ poss = desc.poss;
  const int* __restrict__ resets = desc.resets;
  const uint8_t* __restrict__ mflags = desc.mflags;
  uint8_t* __restrict__ syms = desc.syms;
  int* const tally = desc.tally;
  E* const table =
      SMEM ? reinterpret_cast<E*>(smem) : static_cast<E*>(desc.table);
  if (SMEM) {  // this CTA's table, fresh; the sacrificial row at PROB_MAX
    for (int i = threadIdx.x; i < g.table_size; i += blockDim.x)
      table[i] = (E)(i < g.sac_base ? PROB_INIT : PROB_MAX);
    __syncthreads();
  }

  // the table's entries; a cluster's CTAs reach the device table past
  // their L1s
  auto tload = [&](int e) -> int {
    return CL ? (int)__ldcg(table + e) : (int)table[e];
  };
  auto tstore = [&](int e, int v) {
    if (CL)
      __stcg(table + e, (E)v);
    else
      table[e] = (E)v;
  };

  // a symbol-step's inputs as loaded (read at their use: a compare right
  // after the load would wait on it); the byte and flag kinds read none
  struct Inputs {
    int rs = 0, pos = 0, mf = 0;
  };
  // the thread's lanes: each one's payload, count, coder and context state,
  // and its symbol-step's inputs and the next one's, loaded ahead
  int w[K], cnt[K];
  bool live[K];
  Bytes in[K];
  uint32_t low[K], rng[K], code[K];
  CtxState st[K];
  Inputs cur[K], nxt[K];
  auto inputs = [&](int t, int i, Inputs* x) {
    if (live[i] && t < Sp && cx.kind <= SEQ) {
      const size_t at = (size_t)t * W + w[i];
      x->rs = resets[at];
      x->pos = poss[at];
      if (p.match) x->mf = mflags[at];
    }
  };
#pragma unroll
  for (int i = 0; i < K; ++i) {
    w[i] = (rank * K + i) * (int)blockDim.x + (int)threadIdx.x;
    live[i] = w[i] < W;
    in[i].init(desc.payload + (size_t)(live[i] ? w[i] : 0) * Lb,
               live[i] ? desc.lens[w[i]] : 0, Lb);
    cnt[i] = live[i] ? desc.counts[w[i]] : 0;
    low[i] = 0;
    rng[i] = 0xFFFFFFFFu;
    code[i] = 0;
    for (int r = 0; r < 4; ++r) code[i] = (code[i] << 8) | in[i].next();
    inputs(0, i, &cur[i]);
    inputs(1, i, &nxt[i]);
  }
  // bit j's entry, b + (nd >> (depth - j)) - 1 with the symbol's final
  // node nd, and its share of the entry's counter: count in bits 0-15,
  // ones in bits 16-31 (at most 4,096 each)
  auto entry = [&](int b, int nd, int j) {
    return b + (nd >> (depth - j)) - 1;
  };
  auto mark = [&](int nd, int j) {
    return 1 | (((nd >> (depth - 1 - j)) & 1) << 16);
  };
  for (int t = 0; t < Sp; ++t) {
    int base[K], rb[K], node[K];
    bool real[K];
    // what each bit of the symbol read: `got[i][j]` (p | visits << 12)
    int got[K][MAX_DEPTH];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const bool act = t < cnt[i];
      base[i] = st[i].row(cx, act, cur[i].rs != 0, (uint32_t)cur[i].pos,
                          cur[i].mf == 1);
      // a real lane's row lies below the sacrificial one, and so does each
      // entry of it
      real[i] = live[i] && base[i] < g.sac_base;
      // the row's first entry in the table: padded rows start at row * 4
      rb[i] = PAD ? base[i] / 3 * 4 : base[i];
      // a padded row, whole: its three entries (and the unused fourth) in
      // one 8-byte (16-bit entries) or 16-byte load
      typename Row::V rw = Row::none();
      if (PAD && real[i]) {
        const auto* src =
            reinterpret_cast<const typename Row::V*>(table + rb[i]);
        rw = CL ? __ldcg(src) : *src;
      }
      // decode every bit of the symbol from the table as the last
      // symbol-step left it: bit j's entry, entry(rb, node, j) with the
      // symbol's final node
      int nd = 1;
#pragma unroll
      for (int j = 0; j < MAX_DEPTH; ++j) {
        if (j < depth) {
          int v = PROB_MAX;
          if (PAD) {  // entry nd - 1 of the row: 0 (level 0), 1 or 2
            v = Row::at(rw, nd);
          } else if (real[i]) {
            v = tload(rb[i] + nd - 1);
          }
          const uint32_t split =
              (rng[i] >> PROB_BITS) * (uint32_t)(v & P_MASK);
          const bool one = code[i] - low[i] >= split;
          if (one) {
            low[i] += split;
            rng[i] -= split;
          } else {
            rng[i] = split;
          }
          for (int r = 0; r < RENORM_ITERS; ++r) {
            bool agree;
            if (!renorm_needed(low[i], rng[i], &agree)) break;
            if (!agree) rng[i] = (0u - low[i]) & (BOT - 1);
            code[i] = (code[i] << 8) | in[i].next();
            low[i] <<= 8;
            rng[i] <<= 8;
          }
          nd = 2 * nd + one;
          got[i][j] = v;
        }
      }
      node[i] = nd;
      // count each bit and its decision at its entry (the counters index
      // the unpadded table); no result is awaited
      if (real[i]) {
#pragma unroll
        for (int j = 0; j < MAX_DEPTH; ++j) {
          if (j < depth) atomicAdd(tally + entry(base[i], nd, j), mark(nd, j));
        }
      }
      const uint32_t sym = act ? (uint32_t)(nd - (1 << depth)) : 0u;
      st[i].advance(cx, sym);
      if (live[i]) syms[(size_t)t * W + w[i]] = (uint8_t)sym;
      cur[i] = nxt[i];
      inputs(t + 2, i, &nxt[i]);
    }
    sync_all<CL>();  // the symbol-step's counts are complete
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (real[i]) {  // every lane on an entry stores the one value it
                      // leaves
        int c[MAX_DEPTH];
#pragma unroll
        for (int j = 0; j < MAX_DEPTH; ++j) {
          if (j < depth) c[j] = __ldcg(tally + entry(base[i], node[i], j));
        }
#pragma unroll
        for (int j = 0; j < MAX_DEPTH; ++j) {
          if (j < depth) {
            const int n = c[j] & 0xFFFF, n1 = c[j] >> 16;
            const int pp = got[i][j] & P_MASK, pvis = got[i][j] >> VIS_SHIFT;
            const int sum = n1 * law_delta<WARM>(g, pp, pvis, n, true) +
                            (n - n1) * law_delta<WARM>(g, pp, pvis, n, false);
            const int nv = WARM ? min(pvis + n, g.vcap) : 0;
            tstore(entry(rb[i], node[i], j),
                   clampi(pp + sum, PROB_MIN, PROB_MAX) | (nv << VIS_SHIFT));
          }
        }
      }
    }
    sync_all<CL>();  // the commits seen before the next symbol-step reads
    // every counter read, each lane takes its marks back out: the adds of
    // the next symbol-step may land before or after (addition commutes),
    // and all of these land before its first barrier, so each counter
    // reads the next symbol-step's marks alone there
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (real[i]) {
#pragma unroll
        for (int j = 0; j < MAX_DEPTH; ++j) {
          if (j < depth)
            atomicSub(tally + entry(base[i], node[i], j), mark(node[i], j));
        }
      }
    }
  }
}

// A lane's state between the phases of the loop form (past REG_LANES):
// its coder, its next payload byte, its context state, and its symbol's
// first entry (sac_base where the lane is not real), final node and reads
// (entries of type E: coder_torch.lane_state_bytes is its size).
template <typename E>
struct LaneState {
  uint32_t low, rng, code;
  int ptr;
  uint32_t sa, sb;
  int base, node;
  E got[MAX_DEPTH];
};

// The loop form of Kernel D: lanes a thread in device memory (LaneState)
// over a cluster, the table in device memory. WIDE: 64-bit counters (count
// in bits 0-31, ones in 32-63), else 32-bit ones (count in bits 0-15, ones
// in 16-31, read unsigned). E: the table entry.
template <bool WARM, bool PAD, bool WIDE, typename E>
__global__ void __launch_bounds__(1024, 1)
    lane_decode_loop_kernel(const __grid_constant__ DecParams p) {
  static_assert(sizeof(E) == 2 || WARM, "32-bit entries warm up");
  using Tally = typename std::conditional<WIDE, unsigned long long,
                                          unsigned>::type;
  using Row = PadRow<E>;
  using Lane = LaneState<E>;
  constexpr int HALF = WIDE ? 32 : 16;
  const int lc = p.lc;
  const int rank = (int)cg::this_cluster().block_rank();
  const DecDesc& desc = p.d[blockIdx.x >> lc];
  const Ctx& cx = p.cx;
  const Geo& g = p.geo;
  const int W = p.W, Lb = desc.Lb, Sp = desc.Sp;
  const int depth = PAD ? 2 : cx.depth;
  const int T = (int)blockDim.x, stride = T << lc;
  const int first = rank * T + (int)threadIdx.x;
  Lane* const st = static_cast<Lane*>(desc.state);
  Tally* const tally = reinterpret_cast<Tally*>(desc.tally);
  E* const table = static_cast<E*>(desc.table);
  const uint8_t* const payload = desc.payload;
  // lane w's payload byte q: row[q] below min(len, Lb), row[Lb - 1] up to
  // len, 0 past len (the plain version's read)
  auto byte = [&](int w, int len, int q) -> uint32_t {
    if (q >= len) return 0u;
    return __ldg(payload + (size_t)w * Lb + min(q, Lb - 1));
  };
  auto entry = [&](int b, int nd, int j) {
    return b + (nd >> (depth - j)) - 1;
  };
  auto mark = [&](int nd, int j) -> Tally {
    return (Tally)1 | ((Tally)((nd >> (depth - 1 - j)) & 1) << HALF);
  };
  for (int w = first; w < W; w += stride) {
    Lane s;
    const int len = desc.lens[w];
    s.low = 0;
    s.rng = 0xFFFFFFFFu;
    s.code = 0;
    for (int q = 0; q < 4; ++q) s.code = (s.code << 8) | byte(w, len, q);
    s.ptr = 4;
    s.sa = s.sb = 0;
    s.base = g.sac_base;
    s.node = 1;
    st[w] = s;
  }
  for (int t = 0; t < Sp; ++t) {
    for (int w = first; w < W; w += stride) {
      Lane s = st[w];
      if (s.base < g.sac_base) {  // take the last symbol-step's marks out
#pragma unroll
        for (int j = 0; j < MAX_DEPTH; ++j)
          if (j < depth)
            atomicAdd(tally + entry(s.base, s.node, j),
                      (Tally)0 - mark(s.node, j));
      }
      const bool act = t < desc.counts[w];
      const size_t at = (size_t)t * W + w;
      bool rs = false, mf = false;
      uint32_t pos = 0;
      if (cx.kind <= SEQ) {
        rs = desc.resets[at] != 0;
        pos = (uint32_t)desc.poss[at];
        if (p.match) mf = desc.mflags[at] == 1;
      }
      CtxState cs;
      cs.sa = s.sa;
      cs.sb = s.sb;
      const int base = cs.row(cx, act, rs, pos, mf);
      const bool real = base < g.sac_base;
      const int rb = PAD ? base / 3 * 4 : base;
      typename Row::V rw = Row::none();
      if (PAD && real)
        rw = __ldcg(reinterpret_cast<const typename Row::V*>(table + rb));
      const int len = desc.lens[w];
      int nd = 1;
#pragma unroll
      for (int j = 0; j < MAX_DEPTH; ++j) {
        if (j < depth) {
          int v = PROB_MAX;
          if (PAD)
            v = Row::at(rw, nd);
          else if (real)
            v = (int)__ldcg(table + rb + nd - 1);
          const uint32_t split = (s.rng >> PROB_BITS) * (uint32_t)(v & P_MASK);
          const bool one = s.code - s.low >= split;
          if (one) {
            s.low += split;
            s.rng -= split;
          } else {
            s.rng = split;
          }
          for (int r = 0; r < RENORM_ITERS; ++r) {
            bool agree;
            if (!renorm_needed(s.low, s.rng, &agree)) break;
            if (!agree) s.rng = (0u - s.low) & (BOT - 1);
            s.code = (s.code << 8) | byte(w, len, s.ptr++);
            s.low <<= 8;
            s.rng <<= 8;
          }
          nd = 2 * nd + one;
          s.got[j] = (E)v;
        }
      }
      if (real) {
#pragma unroll
        for (int j = 0; j < MAX_DEPTH; ++j)
          if (j < depth) atomicAdd(tally + entry(base, nd, j), mark(nd, j));
      }
      const uint32_t sym = act ? (uint32_t)(nd - (1 << depth)) : 0u;
      cs.advance(cx, sym);
      desc.syms[at] = (uint8_t)sym;
      s.sa = cs.sa;
      s.sb = cs.sb;
      s.base = real ? base : g.sac_base;
      s.node = nd;
      st[w] = s;
    }
    sync_all<true>();  // the symbol-step's counts are complete
    for (int w = first; w < W; w += stride) {
      const Lane& s = st[w];
      const int base = s.base, nd = s.node;
      if (base >= g.sac_base) continue;
      const int rb = PAD ? base / 3 * 4 : base;
#pragma unroll
      for (int j = 0; j < MAX_DEPTH; ++j) {
        if (j < depth) {
          const Tally c = __ldcg(tally + entry(base, nd, j));
          const int n = (int)(c & (((Tally)1 << HALF) - 1));
          const int n1 = (int)(c >> HALF);
          const int pp = s.got[j] & P_MASK, pvis = s.got[j] >> VIS_SHIFT;
          const int sum = n1 * law_delta<WARM>(g, pp, pvis, n, true) +
                          (n - n1) * law_delta<WARM>(g, pp, pvis, n, false);
          const int nv = WARM ? min(pvis + n, g.vcap) : 0;
          __stcg(table + entry(rb, nd, j),
                 (E)(clampi(pp + sum, PROB_MIN, PROB_MAX) | (nv << VIS_SHIFT)));
        }
      }
    }
    sync_all<true>();  // the commits seen before the next symbol-step reads
  }
}

// One barrier of `blockDim` threads (of every CTA of the cluster, CL) per
// loop step: the latency that bounds Kernel D's symbol-step from below.
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
// (one CTA where cluster is 1), `per_thread` lanes a thread (2 or 4 only
// for a table in shared memory), in the shape coder_torch.decode_shape
// derived: smem_table, the table in the CTA's shared memory (one CTA a
// block; else the descriptors' device tables); padded, a depth-2 device
// table laid out in rows padded to 4 entries (the descriptors' counters
// keep the unpadded layout of table_size entries); bytes, a CTA's dynamic
// shared memory. vcap: the saturating visit count, 0 without warm-up;
// ebytes: a table entry's bytes, 2, or 4 where vcap passes 15
// (coder_torch.entry_bytes). match: the descriptors carry a format-v5 SEQ
// stream's [Sp, W] match-span flags. A shape that does not hold is refused
// (cudaErrorInvalidValue), as is a launch the card refuses; nothing else
// is launched in its place.
int lane_decode(const void* descs, int n, int W, int table_size,
                int sac_base, int rate, int rate_lo, int vcap, int depth,
                int kind, int num_ctx, int k0, int k1, int k2, int k3,
                int match, int cluster, int threads, int smem_table,
                int padded, int bytes, int per_thread, int ebytes,
                cudaStream_t stream) {
  int lc = 0;
  while ((1 << lc) < cluster) ++lc;
  // past REG_LANES the loop form: a device table, any lanes a thread
  const bool loop = W > REG_LANES;
  bool states = true;
  for (int i = 0; i < n; ++i)
    states = states && (static_cast<const DecDesc*>(descs)[i].state !=
                        nullptr) == loop;
  const bool ok =
      n >= 1 && n <= MAX_BLOCKS && W >= 1 && states &&
      cluster >= 1 && cluster <= MAX_CLUSTER && (1 << lc) == cluster &&
      threads >= 32 &&
      threads <= (cluster > 1 && !loop ? 512 : 1024) &&
      threads % 32 == 0 &&
      (loop ? cluster > 1 && !smem_table && (long long)threads * cluster * per_thread >= W &&
                  (long long)threads * cluster * (per_thread - 1) < W
            : (per_thread == 1 ||
               (smem_table &&
                (per_thread == 2 || per_thread == MAX_PER_THREAD))) &&
                  threads * cluster * per_thread >= W) &&
      depth >= 1 && depth <= MAX_DEPTH &&
      (!smem_table || cluster == 1) &&
      (!padded || (!smem_table && depth == 2 && table_size % 3 == 0)) &&
      ebytes == (vcap < (1 << 4) ? 2 : 4) && vcap <= (1 << 9) &&
      bytes == (smem_table ? table_smem_bytes(table_size, ebytes) : 0) &&
      bytes <= SMEM_LIMIT;
  if (!ok) return (int)cudaErrorInvalidValue;
  DecParams p = {};
  for (int i = 0; i < n; ++i) p.d[i] = static_cast<const DecDesc*>(descs)[i];
  p.geo = Geo{table_size, sac_base, rate, rate_lo, vcap};
  p.cx = Ctx{kind, depth, num_ctx, k0, k1, k2, k3};
  p.W = W;
  p.lc = lc;
  p.match = match;
  auto go = [&](auto kern) -> int {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    e = launch_clusters(kern, n * cluster, threads, cluster, bytes, stream,
                        p);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  };
  // 32-bit entries only where the geometry warms up past a cap of 15
  const bool wide_entry = ebytes == 4;
  // a table in shared memory: one CTA, 1, 2 or 4 lanes a thread
  auto sm = [&](auto k) -> int {
    constexpr int K = decltype(k)::value;
    if (wide_entry)
      return go(lane_decode_kernel<true, false, true, false, K, uint32_t>);
    return vcap
               ? go(lane_decode_kernel<true, false, true, false, K, uint16_t>)
               : go(lane_decode_kernel<true, false, false, false, K, uint16_t>);
  };
  if (loop) {  // lanes a thread in device memory, over a cluster
    auto lp = [&](auto pad, auto wide) -> int {
      constexpr bool P = decltype(pad)::value, WD = decltype(wide)::value;
      if (wide_entry)
        return go(lane_decode_loop_kernel<true, P, WD, uint32_t>);
      return vcap ? go(lane_decode_loop_kernel<true, P, WD, uint16_t>)
                  : go(lane_decode_loop_kernel<false, P, WD, uint16_t>);
    };
    auto lw = [&](auto pad) -> int {
      return W >= WIDE_LANES ? lp(pad, std::true_type{})
                             : lp(pad, std::false_type{});
    };
    return padded ? lw(std::true_type{}) : lw(std::false_type{});
  }
  if (smem_table)
    return per_thread == 1   ? sm(std::integral_constant<int, 1>{})
           : per_thread == 2 ? sm(std::integral_constant<int, 2>{})
                             : sm(std::integral_constant<int, 4>{});
  // a device table: one CTA or a cluster, rows padded or not
  auto dev = [&](auto cl, auto pad) -> int {
    constexpr bool C = decltype(cl)::value, P = decltype(pad)::value;
    if (wide_entry)
      return go(lane_decode_kernel<false, C, true, P, 1, uint32_t>);
    return vcap ? go(lane_decode_kernel<false, C, true, P, 1, uint16_t>)
                : go(lane_decode_kernel<false, C, false, P, 1, uint16_t>);
  };
  auto dp = [&](auto cl) -> int {
    return padded ? dev(cl, std::true_type{}) : dev(cl, std::false_type{});
  };
  return cluster > 1 ? dp(std::true_type{}) : dp(std::false_type{});
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
