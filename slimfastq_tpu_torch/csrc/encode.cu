// Kernel E (lane_encode): the decoupled encode of one stream of each block
// of a window.
//
// Replaces: slimfastq_tpu/ops/streams_jax.py `_build_encode` (the encode
// coder scan) together with the schedule it reads, `_ctx_precompute` +
// `_build_schedule` / `_build_schedule_ll` (every bit-step's table index
// and bit), with and without the match-context family. Those are plain XLA
// programs, not Pallas, but they carry the whole coding loop.
//
// Contract (byte-identical to the JAX package and its NumPy oracle): W
// lanes advance in lockstep, one binary decision per lane per bit-step,
// through a carry-less 32-bit range coder with byte renorm, against one
// shared adaptive table under the batch-synchronous collision-capped law
// (ctx.cuh, law_delta; coder.cu states it in full). Bit j of symbol-step
// t takes entry row + ((1 << j) | (sym >> (depth - j))) - 1 and codes bit
// (sym >> (depth - 1 - j)) & 1; a step at or past its lane's count codes
// symbol 0 in the sacrificial row, which never adapts.
//
// The law in decoupled form. At bit-step s every real lane on entry e reads
// the same p and visit count and sees the same count n of real lanes on
// e; the k lanes coding a 1 add the same delta d1, the others the same d0.
// So p(s+1) = clamp(p + k*d1 + (n-k)*d0, 16, 4080) and vis += n: the
// table's evolution depends on the symbols alone, never on the coder. The
// encode therefore splits into phases with no lane-wide barrier in the
// coding, each a separate launch over its own parallel axis:
//   1. rows (symbol-steps): each step's first table entry, its lane's
//      context (CtxState, ctx.cuh: the function Kernel D decodes with)
//      rebuilt from the step's last few symbols, which alone decide it;
//   2. touches (bit-steps): per bit-step, the real lanes grouped by entry in
//      a shared-memory hash into records (entry, n, k), numbered within the
//      step in the order of each entry's first lane (so the output is
//      deterministic); a counting pass, an exclusive scan of the counts
//      (each step's first record) and a writing pass that also gives every
//      decision its record's number within the step (rid; all ones for a
//      sacrificial one). One CTA holds a step's 4,096 lanes or fewer, its
//      hash 2W slots or more; past that, chunks of 256 lanes with the
//      hash in device memory. From 65,536 lanes n, k, rid are 32-bit.
//   3. sort (records): the records grouped by entry with an LSD radix sort
//      of 8-bit digits over the key's bits, each pass a tile histogram, an
//      exclusive scan and a stable scatter (ranks within a tile from
//      __match_any_sync, in record order), so an entry's records stay in
//      step order.
//   4. entry scan (entries): one thread an entry walks its records in step
//      order and writes p as it stood before each record over the record's
//      (n, k); its chain is the entry's touches, at most the slice's
//      symbol-steps.
//   5. gather (decisions): each decision's p through its record, with its
//      bit, written over its rid (a u16: p | bit << 15);
//   6. lane coder (lanes): each lane codes its decisions alone from them
//      (one coalesced u16 a decision, loaded PF decisions ahead of its
//      use), emitting into its chunk windows as the lockstep coder did:
//      no barrier.
// A window's B blocks share every launch (block b's records lie between
// its steps' first offsets, cnt[b L] and cnt[(b+1) L]; an entry's records
// are grouped across blocks in block order, and the scan walks each
// block's run of them against that block's table). Slices of L bit-steps bound
// the scratch whatever the stream's length: the table and each lane's
// low, range and chunk position carry from one slice to the next (a slice
// may end inside a symbol); the lane coder of one slice runs beside the
// other phases of the next (two CUDA streams). One host call, enc_run,
// issues a launch set's slices.
//
// Bound on the H100: the function is bound by its bytes (3.35 TB/s) — the
// symbols and step inputs read once, the chunk buffers written once. This
// design's floor is the lane coder's chain: one lane's decisions in order,
// ~10 dependent integer operations each, on 1,024 lanes (one warp an SM,
// 32 SMs); it measures ~0.14 us a decision, which sets E's time (the
// pinned 64k block's QUAL 6.04 ms, 38,400 decisions a lane; PERF.md). The
// other phases spread over every SM, the entry scan's chain being the
// hottest entry's touches.

#include <climits>
#include <type_traits>

#include "ctx.cuh"

namespace {

constexpr int EMPTY = -1;
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_THREADS = 256;
constexpr int SORT_ROUNDS = 4;
constexpr int TILE = SORT_THREADS * SORT_ROUNDS;  // records a sort tile
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;
constexpr int STEPS_PER_CTA = 16;  // bit-steps a touches CTA walks
constexpr int ROW_THREADS = 128;
constexpr int PF = 16;  // decisions the lane coder loads ahead
constexpr int SP = 8;  // records an entry scan load stage runs ahead
// record fields below WIDE_LANES: n (bits 0-15), k (16-31); from
// WIDE_LANES lanes on n in nk and k in kk, and rid 32 bits
constexpr int NK_BITS = 16;
constexpr int WIDE_LANES = 1 << 16;  // encode_torch.WIDE_LANES
constexpr int CTA_LANES = 4096;  // lanes the touches hold in one CTA
constexpr int MAX_PER_THREAD = 4;  // a touches thread's lanes
// the gather's u16 a decision: p (bits 0-11), its bit at BIT_SHIFT
constexpr int BIT_SHIFT = 15;

// One block's stream (the wrapper uploads B of them).
struct Block {
  const uint8_t* syms;    // [Sp, W]
  const int* poss;        // [Sp, W]; null for the byte and flag kinds
  const int* resets;      // [Sp, W]; null for the byte and flag kinds
  const int* counts;      // [W]
  const uint8_t* mflags;  // [Sp, W]; null without the match family
  uint8_t* ebufs;         // [NC, W, CB]
  int* eptrs;             // [NC, W]
  int Sp, NC;
};

// One launch set's scratch, carried state and shape (encode_torch's
// _Plan mirrors it field by field).
struct Plan {
  const Block* blocks;  // [B], device memory
  int* rows;            // [B, Lt, W]: each symbol-step's first entry
  int* cnt;             // [B * L + 1]: records a step, then their offsets
  void* rid;            // [B, L, W] u16 (u32 from WIDE_LANES): each
                        // decision's record in its step, then (the
                        // gather) its p | bit << 15
  int* key;             // [Dcap]: the records' entries (sort buffer 0)
  uint32_t* nk;         // [Dcap]: n | k << 16 (n from WIDE_LANES), then p
  uint32_t* kk;         // [Dcap]: k from WIDE_LANES lanes, else null
  int* key1;            // [Dcap]: sort buffer 1
  int* val1;            // [Dcap]
  int* val2;            // [Dcap]
  int* hist;            // [RADIX, ntiles]: a pass's histogram
  int* parts;           // scan partial sums
  void* tables;         // [B, table_size]: p | vis << 12, entries of
                        // `ebytes` (coder_torch.entry_bytes)
  uint32_t* coder;      // [B, 3, W]: low, range, chunk position carried
  uint32_t* low;        // [B, W]: the final low
  int* emax;            // [B]: each block's largest chunk count
  // the touches past CTA_LANES (else null): each step's hash of 2^nsl
  // slots in device memory, [B * L, 2^nsl] (the entry, then the record's
  // number; n | k << 32; the first lane), each decision's slot [Dcap] (-1
  // for a sacrificial one) and the chunks' counts [B * L * nch + 1]
  int* hkey;
  unsigned long long* hcnt;
  int* hfirst;
  int* hslot;
  int* ccnt;
  Geo geo;
  Ctx cx;
  int B, W, CB, L, Lt, Dcap, ntiles, nbits;
  int wide;  // W >= WIDE_LANES: n and k apart, rid 32 bits
  // the touches launch (encode_torch.touch_shape): threads, lanes a thread,
  // log2 of the hash's slots, dynamic shared memory (0 past CTA_LANES,
  // whose chunks of `tthreads` lanes number nch a step)
  int tthreads, tlanes, nsl, tbytes, nch;
  int ebytes;  // a table entry's bytes: 2, or 4 where vcap passes 15
};

// rid's sacrificial value: all ones of its width
template <typename R>
__host__ __device__ constexpr R no_record() {
  return (R)~(R)0;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// ---------------------------------------------------------------------------
// phase 1: rows
// ---------------------------------------------------------------------------

// The context state at a step depends on the last `hist` symbol-steps
// alone (QUAL two symbols, SEQ its order, BYTE one, FLAG its history
// bits; a read start clears it), so each step's row is built from that
// window, from a zero state, with the function Kernel D decodes with.
__global__ void __launch_bounds__(ROW_THREADS)
    rows_kernel(const __grid_constant__ Plan p, int s0) {
  const int b = blockIdx.y;
  const size_t i = (size_t)blockIdx.x * ROW_THREADS + threadIdx.x;
  const int W = p.W, depth = p.cx.depth;
  const Block d = p.blocks[b];  // in registers: stores cannot alias it
  const int t0 = s0 / depth, t = t0 + (int)(i / W), w = (int)(i % W);
  const int S = d.Sp * depth;
  if (s0 >= S || t >= (min(s0 + p.L, S) + depth - 1) / depth) return;
  const int cnt = d.counts[w];
  const int hist = p.cx.kind == QUAL ? 2 : (p.cx.kind == BYTE ? 1 : p.cx.k0);
  CtxState st;
  int row = 0;
  for (int u = max(t - hist, 0); u <= t; ++u) {
    const size_t at = (size_t)u * W + w;
    const bool act = u < cnt;
    const bool rs = d.resets != nullptr && d.resets[at] != 0;
    const uint32_t pos = d.poss != nullptr ? (uint32_t)d.poss[at] : 0u;
    const bool mf = d.mflags != nullptr && d.mflags[at] == 1;
    row = st.row(p.cx, act, rs, pos, mf);
    st.advance(p.cx, act ? d.syms[at] : 0u);
  }
  p.rows[((size_t)b * p.Lt + (t - t0)) * W + w] = row;
}

// ---------------------------------------------------------------------------
// phase 2: touches
// ---------------------------------------------------------------------------

// the slot of `k` (linear probing; at most W keys in >= 2W slots)
__device__ __forceinline__ int hash_find(int* key, int nsl, int k) {
  const unsigned m = (1u << nsl) - 1;
  unsigned h = ((unsigned)k * 2654435761u) >> (32 - nsl);
  for (;;) {
    const int old = atomicCAS(key + h, EMPTY, k);
    if (old == EMPTY || old == k) return (int)h;
    h = (h + 1) & m;
  }
}

// COUNT: each step's record count into cnt; WRITE: the records at the
// scanned offsets and each decision's rid. K lanes a thread: lane i T + t
// on thread t of T, so lanes run in (round i, thread) order and a step's
// records are numbered by their first lane. Shared memory: two buffers (by
// step parity) of key, n | k << 16 and first lane, 2^nsl slots each, and
// two of the representative counts of each round's warps.
template <bool WRITE, int K>
__global__ void __launch_bounds__(1024)
    touch_kernel(const __grid_constant__ Plan p, int s0) {
  extern __shared__ __align__(16) int hs[];
  const int nsl = p.nsl, NS = 1 << nsl;
  int* key = hs;
  int* nkc = hs + 2 * NS;
  int* first = hs + 4 * NS;
  int* wc = hs + 6 * NS;  // [2][K][32]
  const int b = blockIdx.y;
  const Block d = p.blocks[b];  // in registers: stores cannot alias it
  const int W = p.W, depth = p.cx.depth, S = d.Sp * depth;
  const int sa = s0 + blockIdx.x * STEPS_PER_CTA;
  const int sb = min(min(sa + STEPS_PER_CTA, s0 + p.L), S);
  if (sa >= sb) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  for (int i = tid; i < 2 * NS; i += T) {
    key[i] = EMPTY;
    nkc[i] = 0;
    first[i] = INT_MAX;
  }
  __syncthreads();
  const int t0 = s0 / depth;
  const int* rows = p.rows + (size_t)b * p.Lt * W;
  const int sac = p.geo.sac_base;
  int t = sa / depth, j = sa - t * depth;
  // each lane's count, and its step's row and symbol, loaded a step ahead
  // of their use
  int cnt[K], row_n[K], prev[K];  // prev: the slot it represented
  uint32_t sym_n[K];
  bool was_rep[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int w = i * T + tid;
    const bool live = w < W;
    cnt[i] = live ? d.counts[w] : 0;
    row_n[i] = live ? rows[(size_t)(t - t0) * W + w] : 0;
    sym_n[i] = live && t < cnt[i] ? d.syms[(size_t)t * W + w] : 0u;
    was_rep[i] = false;
    prev[i] = 0;
  }
  for (int s = sa; s < sb; ++s) {
    const int buf = (s & 1) * NS;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (was_rep[i]) {  // clear last step's slot (the other buffer)
        const int at = ((s - 1) & 1) * NS + prev[i];
        key[at] = EMPTY;
        nkc[at] = 0;
        first[at] = INT_MAX;
      }
    }
    const int jj = j;
    if (++j == depth) {
      j = 0;
      ++t;
    }
    int entry[K], slot[K];
    bool real[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int w = i * T + tid;
      const bool live = w < W;
      const int row = row_n[i];
      const uint32_t sym = sym_n[i];
      if (live && s + 1 < sb) {
        row_n[i] = rows[(size_t)(t - t0) * W + w];
        sym_n[i] = t < cnt[i] ? d.syms[(size_t)t * W + w] : 0u;
      }
      entry[i] = row + (int)((1u << jj) | (sym >> (depth - jj))) - 1;
      const uint32_t one = (sym >> (depth - 1 - jj)) & 1u;
      real[i] = live && entry[i] < sac;
      // the warp's lanes on one entry act through their lowest lane: one
      // insert and one add a warp and entry
      const unsigned peers = __match_any_sync(
          FULL, real[i] ? entry[i] : (int)(0x80000000u | lane));
      const int lead = __ffs(peers) - 1;
      const unsigned ones = __ballot_sync(FULL, real[i] && one) & peers;
      int sl = 0;
      if (real[i] && lead == lane) {
        sl = buf + hash_find(key + buf, nsl, entry[i]);
        atomicAdd(nkc + sl, __popc(peers) + (__popc(ones) << 16));
        atomicMin(first + sl, w);
      }
      slot[i] = __shfl_sync(FULL, sl, lead);
    }
    __syncthreads();
    bool rep[K];
    unsigned bal[K];
    int* wcs = wc + (s & 1) * K * 32;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      rep[i] = real[i] && first[slot[i]] == i * T + tid;
      bal[i] = __ballot_sync(FULL, rep[i]);
      if (lane == 0) wcs[i * 32 + warp] = __popc(bal[i]);
    }
    __syncthreads();
    const size_t step = (size_t)b * p.L + (s - s0);
    if (!WRITE) {
      if (tid == 0) {
        int tot = 0;
        for (int i = 0; i < K; ++i)
          for (int v = 0; v < nwarps; ++v) tot += wcs[i * 32 + v];
        p.cnt[step] = tot;
      }
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (rep[i]) {  // its number: the representatives of lower lanes
          int local = __popc(bal[i] & lanemask_lt());
          for (int u = 0; u < i; ++u)
            for (int v = 0; v < nwarps; ++v) local += wcs[u * 32 + v];
          for (int v = 0; v < warp; ++v) local += wcs[i * 32 + v];
          const int at = p.cnt[step] + local;
          p.key[at] = entry[i];
          p.nk[at] = (uint32_t)nkc[slot[i]];
          first[slot[i]] = local;  // every read of first[] came before
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int w = i * T + tid;
        if (w < W)
          static_cast<uint16_t*>(p.rid)[step * W + w] =
              real[i] ? (uint16_t)first[slot[i]] : no_record<uint16_t>();
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      was_rep[i] = rep[i];
      prev[i] = slot[i] - buf;
    }
  }
}

// ---------------------------------------------------------------------------
// phase 2 past CTA_LANES: the touches over chunks of a step's lanes, the
// step's hash (at least 2W slots) in device memory. The chunks insert
// (entry, n | k << 32, first lane), count their representatives (each
// entry's first lane), an exclusive scan of the chunks' counts in step and
// lane order numbers the records, each representative writes its record
// and leaves its number in its slot, and every decision reads it there.
// From WIDE_LANES lanes a record keeps n in nk and k in kk, rid 32 bits.
// ---------------------------------------------------------------------------

// the slot of `k` in a step's hash of 2^nsl slots (linear probing)
__device__ __forceinline__ int hash_find_dev(int* key, int nsl, int k) {
  const unsigned m = (1u << nsl) - 1;
  unsigned h = ((unsigned)k * 2654435761u) >> (32 - nsl);
  for (;;) {
    const int old = atomicCAS(key + h, EMPTY, k);
    if (old == EMPTY || old == k) return (int)h;
    h = (h + 1) & m;
  }
}

// CTA (chunk, step, block) of the touches past CTA_LANES: its step's
// place among the launch set's (b L + s - s0), or -1 past the block's
// stream or the slice, and lane w of the chunk
struct Chunk {
  size_t step;
  int s, w;
  bool in;
};

__device__ __forceinline__ Chunk chunk_of(const Plan& p, int s0) {
  const int b = blockIdx.z, s = s0 + (int)blockIdx.y;
  const int S = p.blocks[b].Sp * p.cx.depth;
  Chunk c;
  c.step = (size_t)b * p.L + blockIdx.y;
  c.s = s;
  c.w = (int)blockIdx.x * p.tthreads + (int)threadIdx.x;
  c.in = s < min(s0 + p.L, S);
  return c;
}

// each real decision's entry into its step's hash: its count and ones
// (a warp's lanes on one entry through their lowest lane) and its first
// lane; every decision's slot (-1: sacrificial or no lane)
__global__ void __launch_bounds__(1024)
    touch_insert_kernel(const __grid_constant__ Plan p, int s0) {
  const Chunk c = chunk_of(p, s0);
  if (!c.in) return;
  const int W = p.W, depth = p.cx.depth, lane = threadIdx.x & 31;
  const Block d = p.blocks[blockIdx.z];
  const int t = c.s / depth, j = c.s - t * depth, t0 = s0 / depth;
  const bool live = c.w < W;
  int entry = 0;
  uint32_t one = 0;
  if (live) {
    const int row =
        p.rows[((size_t)blockIdx.z * p.Lt + (t - t0)) * W + c.w];
    const uint32_t sym =
        t < d.counts[c.w] ? d.syms[(size_t)t * W + c.w] : 0u;
    entry = row + (int)((1u << j) | (sym >> (depth - j))) - 1;
    one = (sym >> (depth - 1 - j)) & 1u;
  }
  const bool real = live && entry < p.geo.sac_base;
  const unsigned peers =
      __match_any_sync(FULL, real ? entry : (int)(0x80000000u | lane));
  const int lead = __ffs(peers) - 1;
  const unsigned ones = __ballot_sync(FULL, real && one) & peers;
  const size_t hs = c.step << p.nsl;
  int sl = -1;
  if (real && lead == lane) {
    sl = hash_find_dev(p.hkey + hs, p.nsl, entry);
    atomicAdd(p.hcnt + hs + sl, (unsigned long long)__popc(peers) +
                                    ((unsigned long long)__popc(ones) << 32));
    atomicMin(p.hfirst + hs + sl, c.w);
  }
  sl = __shfl_sync(FULL, sl, lead);
  if (live) p.hslot[c.step * W + c.w] = real ? sl : -1;
}

// whether lane w represents its decision's entry (its first lane)
__device__ __forceinline__ bool touch_rep(const Plan& p, const Chunk& c,
                                          int* slot) {
  *slot = c.w < p.W ? p.hslot[c.step * p.W + c.w] : -1;
  return *slot >= 0 && p.hfirst[(c.step << p.nsl) + *slot] == c.w;
}

// each chunk's representatives, in ccnt[step nch + chunk]
__global__ void __launch_bounds__(1024)
    touch_count_kernel(const __grid_constant__ Plan p, int s0) {
  const Chunk c = chunk_of(p, s0);
  if (!c.in) return;
  int slot;
  const int n = __syncthreads_count(touch_rep(p, c, &slot));
  if (threadIdx.x == 0) p.ccnt[c.step * p.nch + blockIdx.x] = n;
}

// each step's first record, from the scanned chunk counts (the total last)
__global__ void touch_offsets_kernel(const __grid_constant__ Plan p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= p.B * p.L) p.cnt[i] = p.ccnt[(size_t)i * p.nch];
}

__device__ int block_excl_scan(int v, int* total);

// each representative's record at its chunk's offset plus its rank among
// the chunk's representatives; its number within the step over its slot's
// entry
template <bool WIDE>
__global__ void __launch_bounds__(1024)
    touch_write_kernel(const __grid_constant__ Plan p, int s0) {
  const Chunk c = chunk_of(p, s0);
  if (!c.in) return;
  int slot, tot;
  const bool rep = touch_rep(p, c, &slot);
  const int rank = block_excl_scan(rep ? 1 : 0, &tot);
  if (!rep) return;
  const int at = p.ccnt[c.step * p.nch + blockIdx.x] + rank;
  const size_t hs = (c.step << p.nsl) + slot;
  p.key[at] = p.hkey[hs];
  const unsigned long long nk = p.hcnt[hs];
  if (WIDE) {
    p.nk[at] = (uint32_t)nk;
    p.kk[at] = (uint32_t)(nk >> 32);
  } else {
    p.nk[at] = (uint32_t)nk | ((uint32_t)(nk >> 32) << NK_BITS);
  }
  p.hkey[hs] = at - p.ccnt[c.step * p.nch];
}

// each decision's rid: its record's number, read from its slot
template <typename R>
__global__ void __launch_bounds__(1024)
    touch_rid_kernel(const __grid_constant__ Plan p, int s0) {
  const Chunk c = chunk_of(p, s0);
  if (!c.in || c.w >= p.W) return;
  const size_t at = c.step * p.W + c.w;
  const int slot = p.hslot[at];
  static_cast<R*>(p.rid)[at] =
      slot >= 0 ? (R)p.hkey[(c.step << p.nsl) + slot] : no_record<R>();
}

// ---------------------------------------------------------------------------
// an exclusive scan of n ints in place (two launches: chunk sums, then each
// chunk scanned from the sum of the chunks before it)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// exclusive scan of one value a thread over the CTA; *total gets the sum
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int ws[32];
  __shared__ int tot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_incl_scan(v);
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < (int)(blockDim.x >> 5) ? ws[lane] : 0;
    const int xi = warp_incl_scan(x);
    ws[lane] = xi - x;
    if (lane == 31) tot = xi;
  }
  __syncthreads();
  const int out = ws[warp] + inc - v;
  *total = tot;
  __syncthreads();  // ws and tot are reused by the next call
  return out;
}

// n: the ints to scan, or, with `total`, RADIX x the sort tiles that
// *total records fill (a radix pass's histogram, sized on the device)
__device__ __forceinline__ int scan_len(int n, const int* total) {
  return total != nullptr ? RADIX * ((*total + TILE - 1) / TILE) : n;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    scan_reduce_kernel(const int* a, int n, const int* total, int* parts) {
  n = scan_len(n, total);
  if ((int)blockIdx.x * SCAN_CHUNK >= n) return;
  const int base = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
  int v = 0, tot;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i)
    if (base + i < n) v += a[base + i];
  block_excl_scan(v, &tot);
  if (threadIdx.x == 0) parts[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    scan_apply_kernel(int* a, int n, const int* total, const int* parts) {
  n = scan_len(n, total);
  if ((int)blockIdx.x * SCAN_CHUNK >= n) return;
  int pre = 0, before, tot;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += blockDim.x)
    pre += parts[i];
  block_excl_scan(pre, &before);  // the sum of the chunks before this one
  const int base = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS], sum = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    v[i] = base + i < n ? a[base + i] : 0;
    sum += v[i];
  }
  int run = block_excl_scan(sum, &tot) + before;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    if (base + i < n) a[base + i] = run;
    run += v[i];
  }
}

// cap: the most ints the scan can be given (its grid)
cudaError_t excl_scan(int* a, int cap, const int* total, int* parts,
                      cudaStream_t st) {
  const int chunks = (cap + SCAN_CHUNK - 1) / SCAN_CHUNK;
  scan_reduce_kernel<<<chunks, SCAN_THREADS, 0, st>>>(a, cap, total, parts);
  scan_apply_kernel<<<chunks, SCAN_THREADS, 0, st>>>(a, cap, total, parts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// phase 3: the records' LSD radix sort by entry
// ---------------------------------------------------------------------------

// the histogram [RADIX, U] of the U tiles the records fill
__global__ void __launch_bounds__(SORT_THREADS)
    radix_hist_kernel(const int* keys, const int* total, int shift, int bits,
                      int* hist) {
  __shared__ int h[RADIX];
  const int tid = threadIdx.x;
  const int N = *total, U = (N + TILE - 1) / TILE;
  if ((int)blockIdx.x >= U) return;
  h[tid] = 0;
  __syncthreads();
  const int base = blockIdx.x * TILE, mask = (1 << bits) - 1;
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int i = base + r * SORT_THREADS + tid;
    if (i < N) atomicAdd(h + ((keys[i] >> shift) & mask), 1);
  }
  __syncthreads();
  hist[(size_t)tid * U + blockIdx.x] = h[tid];
}

// vals_in null: the values are the records' own numbers (the first pass)
__global__ void __launch_bounds__(SORT_THREADS)
    radix_scatter_kernel(const int* keys_in, const int* vals_in,
                         int* keys_out, int* vals_out, const int* total,
                         int shift, int bits, const int* hist) {
  __shared__ int run[RADIX];
  __shared__ int wc[SORT_THREADS / 32][RADIX + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = *total, base = blockIdx.x * TILE, mask = (1 << bits) - 1;
  if (base >= N) return;
  run[tid] = hist[(size_t)tid * ((N + TILE - 1) / TILE) + blockIdx.x];
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int i = base + r * SORT_THREADS + tid;
    const bool valid = i < N;
    const int k = valid ? keys_in[i] : 0;
    const int v = valid ? (vals_in != nullptr ? vals_in[i] : i) : 0;
    const int dg = valid ? (k >> shift) & mask : RADIX;
    for (int x = tid; x < (SORT_THREADS / 32) * (RADIX + 1);
         x += SORT_THREADS)
      (&wc[0][0])[x] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(FULL, dg);
    const unsigned before = peers & lanemask_lt();
    if (before == 0) wc[warp][dg] = __popc(peers);
    __syncthreads();
    {  // thread tid owns digit tid: the warps' offsets in warp order
      int acc = run[tid];
      for (int v2 = 0; v2 < SORT_THREADS / 32; ++v2) {
        const int c = wc[v2][tid];
        wc[v2][tid] = acc;
        acc += c;
      }
      run[tid] = acc;
    }
    __syncthreads();
    if (valid) {
      const int pos = wc[warp][dg] + __popc(before);
      keys_out[pos] = k;
      vals_out[pos] = v;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// phase 4: the entry scan
// ---------------------------------------------------------------------------

// WIDE: n in nk and k in kk (from WIDE_LANES lanes), a template argument
// so that the record loop of the 16-bit form stays as it was; E: the
// table entry, uint16_t or (a visit cap past 15, WARM only) uint32_t, so
// the visit count carried from slice to slice is whole
template <bool WARM, bool WIDE, typename E>
__global__ void __launch_bounds__(256)
    entry_scan_kernel(const __grid_constant__ Plan p, const int* K,
                      const int* V) {
  static_assert(sizeof(E) == 2 || WARM, "32-bit entries warm up");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = p.cnt[(size_t)p.B * p.L];
  if (i >= N) return;
  const int e = K[i];
  if (i > 0 && K[i - 1] == e) return;
  // the group's end: galloping, then a binary search (K is sorted)
  int lo = i, step = 1;
  while (lo + step < N && K[lo + step] == e) {
    lo += step;
    step *= 2;
  }
  int hi = min(lo + step, N);  // K[lo] == e, K[hi] != e or hi == N
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (K[mid] == e) lo = mid; else hi = mid;
  }
  const int end = hi;
  const Geo& g = p.geo;
  // a two-stage load pipeline SP records deep: the record's number, then
  // its n | k; `stop`: the end of the run it walks. The loads run ahead
  // unguarded (clamped to the run's last record) and only the records'
  // steps are guarded: with guarded loads and an early exit the compiler
  // waited on each load as it landed (the pinned 64k block's IDD scan on
  // an H100: 0.70 ms this way, 1.64 guarded; tools/block_spans.py)
  int v1[SP], v2[SP], stop = end;
  uint32_t n2[SP];
  auto st1 = [&](int k, int j) { v1[k] = V[min(j, stop - 1)]; };
  auto st2 = [&](int k, int j) {
    v2[k] = v1[k];
    n2[k] = p.nk[v1[k]];
  };
  // the group's records run block by block (their numbers rise along the
  // group, and block b's are those from cnt[b L] to cnt[(b+1) L]): each
  // run starts at the last block whose first record is at or before its
  // first one and ends at the group's first record past that block
  for (int j0 = i; j0 < end; j0 = stop) {
    const int r0 = V[j0];
    int b = 0, bh = p.B;
    while (bh - b > 1) {
      const int mid = (b + bh) / 2;
      if (p.cnt[(size_t)mid * p.L] <= r0) b = mid; else bh = mid;
    }
    const int past = p.cnt[(size_t)(b + 1) * p.L];
    stop = end;
    if (V[end - 1] >= past) {
      int below = j0, at = end - 1;  // V[below] < past <= V[at]
      while (at - below > 1) {
        const int mid = (below + at) / 2;
        if (V[mid] < past) below = mid; else at = mid;
      }
      stop = at;
    }
    E* const ent = static_cast<E*>(p.tables) + (size_t)b * g.table_size + e;
    int pr = *ent & P_MASK, vis = *ent >> VIS_SHIFT;
#pragma unroll
    for (int k = 0; k < SP; ++k) {
      st1(k, j0 + k);
      st2(k, j0 + k);
      st1(k, j0 + SP + k);
    }
    for (int j = j0; j < stop; j += SP) {
#pragma unroll
      for (int k = 0; k < SP; ++k) {
        const int jk = j + k;
        const int r = v2[k];
        const uint32_t nk = n2[k];
        st2(k, jk + SP);
        st1(k, jk + 2 * SP);
        if (jk < stop) {
          const int n = WIDE ? (int)nk : (int)(nk & ((1u << NK_BITS) - 1));
          const int kk = WIDE ? (int)p.kk[r] : (int)(nk >> NK_BITS);
          p.nk[r] = (uint32_t)pr;
          const int d1 = law_delta<WARM>(g, pr, vis, n, true);
          const int d0 = law_delta<WARM>(g, pr, vis, n, false);
          pr = clampi(pr + kk * d1 + (n - kk) * d0, PROB_MIN, PROB_MAX);
          if (WARM) vis = min(vis + n, g.vcap);
        }
      }
    }
    *ent = (E)(pr | (vis << VIS_SHIFT));
  }
}

// ---------------------------------------------------------------------------
// phase 5: the gather
// ---------------------------------------------------------------------------

template <typename R>
__global__ void __launch_bounds__(256)
    gather_kernel(const __grid_constant__ Plan p, int s0) {
  const int b = blockIdx.y;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  const int W = p.W, depth = p.cx.depth;
  const Block d = p.blocks[b];
  const int s = s0 + (int)(i / W), w = (int)(i % W);
  if (s >= min(s0 + p.L, d.Sp * depth)) return;
  const int t = s / depth, j = s - t * depth;
  R* at = static_cast<R*>(p.rid) + ((size_t)b * p.L + (s - s0)) * W + w;
  const R ri = *at;
  const uint32_t sym = t < d.counts[w] ? d.syms[(size_t)t * W + w] : 0u;
  const uint32_t pv =
      ri == no_record<R>()
          ? (uint32_t)PROB_MAX
          : p.nk[p.cnt[(size_t)b * p.L + (s - s0)] + ri];
  *at = (R)(pv | (((sym >> (depth - 1 - j)) & 1u) << BIT_SHIFT));
}

// ---------------------------------------------------------------------------
// phase 6: the lane coder
// ---------------------------------------------------------------------------

template <typename R>
__global__ void __launch_bounds__(32)
    lane_code_kernel(const __grid_constant__ Plan p, int s0) {
  const int b = blockIdx.y, w = blockIdx.x * 32 + threadIdx.x;
  if (w >= p.W) return;
  const Block d = p.blocks[b];  // in registers: stores cannot alias it
  const int W = p.W, depth = p.cx.depth, CB = p.CB, S = d.Sp * depth;
  if (s0 >= S) return;
  const int s1 = min(s0 + p.L, S), KD = CHUNK_SYMS * depth;
  uint32_t* carry = p.coder + (size_t)b * 3 * W;
  uint32_t low = 0, rng = 0xFFFFFFFFu;
  int eptr = 0;
  if (s0 > 0) {
    low = carry[w];
    rng = carry[W + w];
    eptr = (int)carry[2 * W + w];
  }
  // each decision's p | bit << 15 ([s - s0][w]), loaded PF decisions
  // ahead of its use: coalesced, and independent of the coder
  const R* __restrict__ pb =
      static_cast<const R*>(p.rid) + (size_t)b * p.L * W + w;
  uint8_t* __restrict__ ebufs = d.ebufs;
  uint32_t q[PF];
#pragma unroll
  for (int k = 0; k < PF; ++k)
    q[k] = s0 + k < s1 ? pb[(size_t)k * W] : 0u;
  int emx = 0;
  int c = s0 / KD, kc = s0 - c * KD;  // the chunk and the bit-step in it
  uint8_t* eb = ebufs + ((size_t)c * W + w) * CB;
  for (int s = s0; s < s1; s += PF) {
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      if (s + k >= s1) break;
      const uint32_t cur = q[k];
      if (s + k + PF < s1) q[k] = pb[(size_t)(s + k + PF - s0) * W];
      const uint32_t split = (rng >> PROB_BITS) * (cur & P_MASK);
      if (cur >> BIT_SHIFT) {
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
      if (++kc == KD) {  // the chunk is complete
        d.eptrs[(size_t)c * W + w] = eptr;
        emx = max(emx, eptr);
        eptr = 0;
        kc = 0;
        eb = ebufs + ((size_t)(++c) * W + w) * CB;
      }
    }
  }
  carry[w] = low;
  carry[W + w] = rng;
  carry[2 * W + w] = (uint32_t)eptr;
  if (s1 == S) p.low[(size_t)b * W + w] = low;
  if (emx) atomicMax(p.emax + b, emx);
}

// whether the touches launch the wrapper derived (encode_torch.touch_shape)
// holds W lanes: up to CTA_LANES, whole warps of at most 1,024 threads, 1,
// 2 or 4 lanes a thread, at least 2W hash slots, its shared memory within
// the CTA's; past it, chunks of whole warps of one lane a thread covering
// the lanes, a step's hash of at least 2W slots in device memory, and the
// record fields 32 bits wide from WIDE_LANES on
bool touch_shape_holds(const Plan& p) {
  const int T = p.tthreads, K = p.tlanes;
  if (p.W < 1 || T < 32 || T > 1024 || T % 32 != 0 || p.nsl < 1 ||
      (size_t)1 << p.nsl < 2 * (size_t)p.W || p.wide != (p.W >= WIDE_LANES))
    return false;
  if (p.W > CTA_LANES)
    return K == 1 && p.tbytes == 0 && p.nsl <= 30 &&
           p.nch == (p.W + T - 1) / T && p.hkey && p.hcnt && p.hfirst &&
           p.hslot && p.ccnt && (p.kk != nullptr) == (p.wide != 0);
  return (K == 1 || K == 2 || K == MAX_PER_THREAD) && T * K >= p.W &&
         p.nsl <= 16 && p.tbytes == (6 * (1 << p.nsl) + 2 * 32 * K) * 4 &&
         p.tbytes <= SMEM_LIMIT;
}

// the phases that read or write rid, on its width: u16, or u32 from
// WIDE_LANES lanes
template <typename R>
cudaError_t launch_rid(const Plan& p, int s0, cudaStream_t stream) {
  touch_rid_kernel<R><<<dim3(p.nch, p.L, p.B), p.tthreads, 0, stream>>>(
      p, s0);
  return cudaGetLastError();
}

template <typename R>
cudaError_t launch_gather(const Plan& p, int s0, cudaStream_t stream) {
  const dim3 grid((unsigned)(((size_t)p.L * p.W + 255) / 256), p.B);
  gather_kernel<R><<<grid, 256, 0, stream>>>(p, s0);
  return cudaGetLastError();
}

template <typename R>
cudaError_t launch_code(const Plan& p, int s0, cudaStream_t stream) {
  const dim3 grid((p.W + 31) / 32, p.B);
  lane_code_kernel<R><<<grid, 32, 0, stream>>>(p, s0);
  return cudaGetLastError();
}

// past CTA_LANES: a step's chunks insert, count their representatives,
// the counts are scanned (each step's first record), and the records and
// rids written
cudaError_t touches_wide(const Plan& p, int s0, cudaStream_t stream) {
  const size_t slots = ((size_t)p.B * p.L) << p.nsl;
  const size_t nc = (size_t)p.B * p.L * p.nch + 1;
  cudaError_t e = cudaMemsetAsync(p.hkey, 0xFF, slots * sizeof(int), stream);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(p.hcnt, 0, slots * sizeof(unsigned long long),
                        stream);
  // 0x7F7F7F7F: past every lane, for atomicMin
  if (e == cudaSuccess)
    e = cudaMemsetAsync(p.hfirst, 0x7F, slots * sizeof(int), stream);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(p.ccnt, 0, nc * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.nch, p.L, p.B);
  touch_insert_kernel<<<grid, p.tthreads, 0, stream>>>(p, s0);
  touch_count_kernel<<<grid, p.tthreads, 0, stream>>>(p, s0);
  e = excl_scan(p.ccnt, (int)nc, nullptr, p.parts, stream);
  if (e != cudaSuccess) return e;
  const int n = p.B * p.L + 1;
  touch_offsets_kernel<<<(n + 255) / 256, 256, 0, stream>>>(p);
  if (p.wide)
    touch_write_kernel<true><<<grid, p.tthreads, 0, stream>>>(p, s0);
  else
    touch_write_kernel<false><<<grid, p.tthreads, 0, stream>>>(p, s0);
  return p.wide ? launch_rid<uint32_t>(p, s0, stream)
                : launch_rid<uint16_t>(p, s0, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Each entry launches its phase's kernels over a launch set described by
// `plan` (a Plan) on `stream` and returns cudaGetLastError(); s0: the
// slice's first bit-step.

int enc_rows(const void* plan, int s0, cudaStream_t stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const dim3 grid(
      (unsigned)(((size_t)p.Lt * p.W + ROW_THREADS - 1) / ROW_THREADS), p.B);
  rows_kernel<<<grid, ROW_THREADS, 0, stream>>>(p, s0);
  return (int)cudaGetLastError();
}

int enc_touches(const void* plan, int s0, cudaStream_t stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.B < 1 || p.B > MAX_BLOCKS || !touch_shape_holds(p))
    return (int)cudaErrorInvalidValue;
  if (p.W > CTA_LANES) return (int)touches_wide(p, s0, stream);
  const int n = p.B * p.L + 1;
  cudaError_t e = cudaMemsetAsync(p.cnt, 0, sizeof(int) * n, stream);
  if (e != cudaSuccess) return (int)e;
  auto go = [&](auto count, auto write) -> cudaError_t {
    for (auto kern : {count, write}) {
      const cudaError_t a = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.tbytes);
      if (a != cudaSuccess) return a;
    }
    const dim3 grid((p.L + STEPS_PER_CTA - 1) / STEPS_PER_CTA, p.B);
    count<<<grid, p.tthreads, p.tbytes, stream>>>(p, s0);
    const cudaError_t a = excl_scan(p.cnt, n, nullptr, p.parts, stream);
    if (a != cudaSuccess) return a;
    write<<<grid, p.tthreads, p.tbytes, stream>>>(p, s0);
    return cudaGetLastError();
  };
  if (p.tlanes == 1)
    e = go(touch_kernel<false, 1>, touch_kernel<true, 1>);
  else if (p.tlanes == 2)
    e = go(touch_kernel<false, 2>, touch_kernel<true, 2>);
  else
    e = go(touch_kernel<false, MAX_PER_THREAD>,
           touch_kernel<true, MAX_PER_THREAD>);
  return (int)e;
}

int enc_sort(const void* plan, cudaStream_t stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const int* total = p.cnt + (size_t)p.B * p.L;
  int* kin = p.key;
  const int* vin = nullptr;
  for (int shift = 0; shift < p.nbits; shift += RADIX_BITS) {
    const int bits = min(RADIX_BITS, p.nbits - shift);
    const bool odd = (shift / RADIX_BITS) % 2 == 0;
    int* kout = odd ? p.key1 : p.key;
    int* vout = odd ? p.val1 : p.val2;
    radix_hist_kernel<<<p.ntiles, SORT_THREADS, 0, stream>>>(
        kin, total, shift, bits, p.hist);
    const cudaError_t e =
        excl_scan(p.hist, RADIX * p.ntiles, total, p.parts, stream);
    if (e != cudaSuccess) return (int)e;
    radix_scatter_kernel<<<p.ntiles, SORT_THREADS, 0, stream>>>(
        kin, vin, kout, vout, total, shift, bits, p.hist);
    kin = kout;
    vin = vout;
  }
  return (int)cudaGetLastError();
}

int enc_scan(const void* plan, cudaStream_t stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.ebytes != (p.geo.vcap < (1 << 4) ? 2 : 4) || p.geo.vcap > (1 << 9))
    return (int)cudaErrorInvalidValue;
  const bool odd = ((p.nbits + RADIX_BITS - 1) / RADIX_BITS) % 2 == 1;
  const int* K = odd ? p.key1 : p.key;
  const int* V = odd ? p.val1 : p.val2;
  const int grid = (p.Dcap + 255) / 256;
  auto go = [&](auto wide) {
    constexpr bool WD = decltype(wide)::value;
    if (p.ebytes == 4)
      entry_scan_kernel<true, WD, uint32_t><<<grid, 256, 0, stream>>>(p, K,
                                                                        V);
    else if (p.geo.vcap)
      entry_scan_kernel<true, WD, uint16_t><<<grid, 256, 0, stream>>>(p, K,
                                                                        V);
    else
      entry_scan_kernel<false, WD, uint16_t><<<grid, 256, 0, stream>>>(p, K,
                                                                         V);
  };
  if (p.wide)
    go(std::true_type{});
  else
    go(std::false_type{});
  return (int)cudaGetLastError();
}

int enc_gather(const void* plan, int s0, cudaStream_t stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  return (int)(p.wide ? launch_gather<uint32_t>(p, s0, stream)
                      : launch_gather<uint16_t>(p, s0, stream));
}

int enc_code(const void* plan, int s0, cudaStream_t stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  return (int)(p.wide ? launch_code<uint32_t>(p, s0, stream)
                      : launch_code<uint16_t>(p, s0, stream));
}

// A whole launch set of S bit-steps, every slice of p.L issued from here in
// the order the phases' entries above take them: the coding stream waits
// for `prep`'s work so far; slice k codes into rid buffer k % 2 (rid0,
// rid1), its rows, touches, sort, entry scan and gather on `prep` (behind
// slice k - 2's lane coder, which read that buffer), its lane coder on
// `coding` behind them; at the end `prep` waits for `coding`. The events
// are released before it returns (the card keeps a pending one until it
// completes). Returns the first error and, in where[0] and where[1], the
// slice and phase it came from (0-5: rows ... lane coder; 6: the streams'
// ordering).
int enc_run(const void* plan, void* rid0, void* rid1, int S,
            cudaStream_t prep, cudaStream_t coding, int* where) {
  constexpr int ORDER = 6;
  Plan p = *static_cast<const Plan*>(plan);
  cudaEvent_t ev[3] = {};  // slice k's lane coder done at ev[k % 2]; a join
  int err = 0;
  // keeps the first error and where it came from; true once there is one
  auto fail = [&](int e, int slice, int phase) {
    if (e != 0 && err == 0) {
      err = e;
      where[0] = slice;
      where[1] = phase;
    }
    return err != 0;
  };
  for (cudaEvent_t& e : ev)
    if (fail(cudaEventCreateWithFlags(&e, cudaEventDisableTiming), 0, ORDER))
      break;
  if (!err && !fail(cudaEventRecord(ev[2], prep), 0, ORDER))
    fail(cudaStreamWaitEvent(coding, ev[2], 0), 0, ORDER);
  int k = 0;
  for (int s0 = 0; !err && s0 < S; ++k, s0 += p.L) {
    p.rid = k % 2 ? rid1 : rid0;
    if ((k >= 2 && fail(cudaStreamWaitEvent(prep, ev[k % 2], 0), k, ORDER)) ||
        fail(enc_rows(&p, s0, prep), k, 0) ||
        fail(enc_touches(&p, s0, prep), k, 1) ||
        fail(enc_sort(&p, prep), k, 2) || fail(enc_scan(&p, prep), k, 3) ||
        fail(enc_gather(&p, s0, prep), k, 4) ||
        fail(cudaEventRecord(ev[2], prep), k, ORDER) ||
        fail(cudaStreamWaitEvent(coding, ev[2], 0), k, ORDER) ||
        fail(enc_code(&p, s0, coding), k, 5) ||
        fail(cudaEventRecord(ev[k % 2], coding), k, ORDER))
      break;
  }
  // after an error too, `prep` is left behind `coding`'s work: the caller
  // frees the buffers on `prep`
  if (ev[2]) {
    const cudaError_t e = cudaEventRecord(ev[2], coding);
    fail(e, k, ORDER);
    if (e == cudaSuccess) fail(cudaStreamWaitEvent(prep, ev[2], 0), k, ORDER);
  }
  for (cudaEvent_t e : ev)
    if (e) cudaEventDestroy(e);
  return err;
}

}  // extern "C"
