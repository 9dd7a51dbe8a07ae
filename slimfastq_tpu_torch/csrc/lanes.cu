// Lane layout: Kernel L (lane_layout) and Kernel U (lane_unpack).
//
// Replaces, from the JAX package:
// * Kernel L, pack mode: slimfastq_tpu/ops/pack_jax.py `_build_pack_pair`
//   (raw block bytes -> SEQ through a 256-entry map and QUAL minus the
//   block's bias, [Sp, W] u8 each) together with streams_jax.py
//   `_pos_reset_device` (pos and reset [Sp, W]), in one launch a block;
// * Kernel L, step-input mode (no bytes): `_pos_reset_device` alone;
// * Kernel U: pack_jax.py `_build_unpack_pair` ([Sp, W] SEQ and QUAL ->
//   two record-major byte buffers through the map and plus the bias).
// Those are XLA programs of whole-array ops (a boundary scatter and a
// running sum down the steps, then a gather or a scatter); in eager
// PyTorch they were ~50 launches a call.
//
// Layout (frozen format rule): record r sits in lane w = r % W as the
// lane's ordinal j = r / W; a lane's records follow one another down its
// rows from row 0, so row s of lane w belongs to the last record j whose
// start (the sum of the lane's lengths before it) is at or below s. A
// record of length 0 owns no row and sets no reset; rows past the lane's
// total take no record (pos carries on as s minus the last start, reset 0,
// the symbols 0: they are never coded).
//
// Design of L: one thread per (lane, run of RUN rows), a warp over 32
// consecutive lanes of one run, so every row a warp writes is one
// coalesced store (32 B of symbols, 128 B of pos or reset). A thread
// walks its lane's records from the first to the one that owns its first
// row (each length one load, the warp's 32 lanes side by side), then down
// its rows, reading each record's bytes in order: a record's bytes stay
// in L1/L2 across the run. U writes record-major bytes, so it transposes
// through shared memory instead (lane_unpack_kernel below): a warp that
// wrote one byte a lane a row would touch 32 records' lines a store. All
// offsets, s * W + w and the source and output addresses are 64-bit.
//
// Bound on the H100: bytes. Pack mode reads the records' bytes once and
// writes 10 bytes a row and lane (two u8, two int32); step-input mode
// writes 8; U reads 2 bytes a row and lane and writes the records'
// bytes (64k L3 block: 13.1 MB raw in, 65.5 MB out; 13.1 MB each way for
// U). L's walk to a run's first record reads up to Rpl lengths a thread
// from L2 (64 at the 64k block); U's scan reads them 32 at a time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RUN = 64;    // rows a thread
constexpr int WARPS = 8;   // runs a CTA (one warp each)

// The record walk of one lane: record j starts at row `start` and has
// `len` rows; `last` is the start of the last record with rows at or
// before the walk's row that starts below S (-1: none yet).
struct Walk {
  const int* lens;
  long long n, W, S;
  int w;
  long long Rpl, j = 0, start = 0, last = -1;
  int len = 0;

  __device__ int len_of(long long i) const {
    const long long r = i * W + w;
    return r < n ? lens[r] : 0;
  }

  __device__ void begin() {
    len = Rpl ? len_of(0) : 0;
    if (len > 0 && start < S) last = start;
  }

  // move to the last record that starts at or below row s
  __device__ void to(long long s) {
    while (j + 1 < Rpl && start + len <= s) {
      start += len;
      len = len_of(++j);
      if (len > 0 && start < S) last = start;
    }
  }

  // row s lies in record j
  __device__ bool owns(long long s) const { return s < start + len; }
};

struct LayoutArgs {
  // pack mode (data null in step-input mode)
  const uint8_t* data;
  long long Dp;
  const long long* off_s;  // [n] per record, relative to data
  const long long* off_q;
  const uint8_t* smap;     // [256]
  int qbias;
  uint8_t* seq;            // [Sp, W]
  uint8_t* qual;
  // both modes
  const int* lens;         // [n] record lengths, record r = j * W + w
  long long n, Sp, S;
  int W;
  int* pos;                // [Sp, W]
  int* reset;
};

__global__ void __launch_bounds__(32 * WARPS)
    lane_layout_kernel(const __grid_constant__ LayoutArgs a) {
  const int w = blockIdx.y * 32 + threadIdx.x;
  const long long run = (long long)blockIdx.x * WARPS + threadIdx.y;
  const long long r0 = run * RUN;
  if (w >= a.W || r0 >= a.Sp) return;
  const long long r1 = min(a.Sp, r0 + RUN);
  Walk k{a.lens, a.n, a.W, a.S, w};
  k.Rpl = (a.n + a.W - 1) / a.W;
  k.begin();
  long long src_s = 0, src_q = 0, at_j = -1;
  for (long long s = r0; s < r1; ++s) {
    k.to(s);
    const size_t at = (size_t)s * a.W + w;
    const long long last = k.last < 0 ? 0 : k.last;
    a.pos[at] = (int)(s - last);
    a.reset[at] = k.last == s;
    if (a.data == nullptr) continue;
    uint8_t sv = 0, qv = 0;
    if (k.owns(s)) {
      if (at_j != k.j) {  // a new record: its sources
        at_j = k.j;
        const long long r = k.j * a.W + w;
        src_s = a.off_s[r] - k.start;
        src_q = a.off_q[r] - k.start;
      }
      const long long i = min(max(src_s + s, 0LL), a.Dp - 1);
      const long long q = min(max(src_q + s, 0LL), a.Dp - 1);
      sv = a.smap[a.data[i]];
      qv = (uint8_t)((int)a.data[q] - a.qbias);
    }
    a.seq[at] = sv;
    a.qual[at] = qv;
  }
}

struct UnpackArgs {
  const uint8_t* seq;      // [Sp, W]
  const uint8_t* qual;
  const long long* offs;   // [n] per record: its first output byte
  const int* lens;         // [n]
  long long n, Sp, total;
  int W;
  const uint8_t* smap;     // [256]
  int qbias;
  uint8_t* seq_out;        // [total]
  uint8_t* qual_out;
};

// Kernel U: one CTA per tile of UT rows x 32 lanes. Its warps first
// stage the tile's SEQ and QUAL bytes in shared memory, each row of 32
// lanes one coalesced 32-byte load; then each warp takes 4 of the lanes
// and writes their records' bytes in record order, 32 consecutive bytes a
// store. A lane's records are found 32 at a time: the warp loads 32
// lengths side by side and scans them (a record's start is the sum of
// the lane's lengths before it), so no thread walks the records one by
// one.
constexpr int UT = 128;      // rows a tile
constexpr int UPAD = UT + 4;  // a lane's row of the staged tile, padded
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(32 * WARPS)
    lane_unpack_kernel(const __grid_constant__ UnpackArgs a) {
  __shared__ uint8_t ts[32][UPAD], tq[32][UPAD];
  const int t = threadIdx.x, warp = threadIdx.y;
  const long long s0 = (long long)blockIdx.x * UT;
  const int w0 = blockIdx.y * 32;
  const int rows = (int)min((long long)UT, a.Sp - s0);
  const long long s1 = s0 + rows;
  if (w0 + t < a.W) {
    for (int r = warp; r < rows; r += WARPS) {
      const size_t at = (size_t)(s0 + r) * a.W + w0 + t;
      ts[t][r] = a.seq[at];
      tq[t][r] = a.qual[at];
    }
  }
  __syncthreads();
  const long long Rpl = (a.n + a.W - 1) / a.W;
  for (int l = warp; l < 32 && w0 + l < a.W; l += WARPS) {
    const int w = w0 + l;
    long long base = 0;  // the lane's rows before record jb
    for (long long jb = 0; jb < Rpl && base < s1; jb += 32) {
      const long long j = jb + t;
      const long long r = j * a.W + w;
      const int len = j < Rpl && r < a.n ? a.lens[r] : 0;
      long long inc = len;  // inclusive scan of the 32 lengths
      for (int o = 1; o < 32; o <<= 1) {
        const long long v = __shfl_up_sync(FULL, inc, o);
        if (t >= o) inc += v;
      }
      const long long st = base + inc - len;
      // records with rows in this tile, taken in order
      unsigned hit = __ballot_sync(FULL, len > 0 && st < s1 && st + len > s0);
      while (hit) {
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        const long long rs = __shfl_sync(FULL, st, src);
        const long long re = rs + __shfl_sync(FULL, (long long)len, src);
        const long long dst = a.offs[(jb + src) * a.W + w] - rs;
        for (long long x = max(rs, s0) + t; x < min(re, s1); x += 32) {
          const long long o = dst + x;
          if (o < 0 || o >= a.total) continue;
          a.seq_out[o] = a.smap[ts[l][x - s0]];
          a.qual_out[o] = (uint8_t)((int)tq[l][x - s0] + a.qbias);
        }
      }
      base += __shfl_sync(FULL, inc, 31);
    }
  }
}

dim3 grid_of(long long Sp, int W) {
  const long long runs = (Sp + RUN - 1) / RUN;
  return dim3((unsigned)((runs + WARPS - 1) / WARPS), (unsigned)((W + 31) / 32));
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel L over one block: pack mode where `data` is given (seq, qual,
// pos and reset written), step-input mode otherwise (pos and reset).
int lane_layout(const uint8_t* data, long long Dp, const long long* off_s,
                const long long* off_q, const uint8_t* smap, int qbias,
                uint8_t* seq, uint8_t* qual, const int* lens, long long n,
                long long Sp, long long S, int W, int* pos, int* reset,
                cudaStream_t stream) {
  if (W < 1 || Sp < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const LayoutArgs a{data, Dp, off_s, off_q, smap, qbias, seq, qual, lens,
                     n, Sp, S, W, pos, reset};
  lane_layout_kernel<<<grid_of(Sp, W), dim3(32, WARPS), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel U over one block.
int lane_unpack(const uint8_t* seq, const uint8_t* qual,
                const long long* offs, const int* lens, long long n,
                long long Sp, long long total, int W, const uint8_t* smap,
                int qbias, uint8_t* seq_out, uint8_t* qual_out,
                cudaStream_t stream) {
  if (W < 1 || Sp < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const UnpackArgs a{seq, qual, offs, lens, n, Sp, total, W, smap, qbias,
                     seq_out, qual_out};
  const dim3 grid((unsigned)((Sp + UT - 1) / UT), (unsigned)((W + 31) / 32));
  lane_unpack_kernel<<<grid, dim3(32, WARPS), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
