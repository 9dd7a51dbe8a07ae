// Lane layout: Kernel L (lane_layout) and Kernel U (lane_unpack).
//
// Replaces, from the JAX package:
// * Kernel L, pair mode: slimfastq_tpu/ops/pack_jax.py `_build_pack_pair`
//   (raw block bytes -> SEQ through a 256-entry map and QUAL minus the
//   block's bias, [Sp, W] u8 each) together with streams_jax.py
//   `_pos_reset_device` (pos and reset [Sp, W]), in one launch a block;
// * Kernel L, step-input mode (no bytes): `_pos_reset_device` alone;
// * Kernel L, single-stream mode: pack_jax.py `_build_pack` (one stream
//   through a map or minus a bias, no pos or reset);
// * Kernel U, pair mode: pack_jax.py `_build_unpack_pair` ([Sp, W] SEQ and
//   QUAL -> two record-major byte buffers through the map and plus the
//   bias); single-stream mode: `_build_unpack` (one stream through a map
//   or plus a bias, into a [Tp] buffer whose bytes past the records' total
//   are the zero byte through the map or plus the bias).
// Those are XLA programs of whole-array ops (a boundary scatter and a
// running sum down the steps, then a gather or a scatter).
//
// Layout (frozen format rule): record r sits in lane w = r % W as the
// lane's ordinal j = r / W; a lane's records follow one another down its
// rows from row 0 (cum_j: the sum of the lane's lengths before record j).
// Row s of lane w takes its bytes from the last record j with cum_j <= s,
// at byte s - cum_j + off_j clamped to [0, Dp - 1]: a record of length 0
// owns no row unless it is the lane's last entry, which owns every row
// from its start to Sp (rows past the lane's total repeat the clamped
// gather of the JAX program). pos is s minus the last start of a record
// with rows at or before s that starts below S (0 where there is none);
// reset is 1 at such a start.
//
// Design of L (a tile of SUB = 32 rows x LT = 64 lanes at a time; a CTA
// walks down `nsub` such tiles of its lanes, one wave of CTAs in all):
// * the CTA first finds, for each of its lanes, the record that owns its
//   first row: a warp loads 32 of a lane's lengths side by side and scans
//   them (a record's start is the sum of the lengths before it), 32
//   records a step, 8 lanes' scans interleaved; no thread walks the
//   records one by one;
// * for each tile, four threads a lane (8 rows each) carry the lane's
//   owner down the rows (the next record's length and offsets loaded one
//   record ahead) and write each row's source byte indices, pos and reset
//   into shared memory, a warp over 32 neighbouring lanes;
// * then every warp gathers a lane's 32 rows at a time: 32 neighbouring
//   source bytes of one or two records, a coalesced load, all of a
//   thread's loads in flight at once, through the map (staged in shared
//   memory) or the bias, into a [row][lane] tile;
// * the tile leaves in 16-byte stores: 16 lanes of u8 symbols or 4 lanes
//   of int32 pos or reset a store (where W is a multiple of 16, resp. 4;
//   one element a store otherwise).
// Element indices s * W + w and the source offsets are 64-bit; rows and
// record offsets relative to the block are 32-bit (the wrapper refuses an
// offset that does not fit).
//
// Bound on the H100: bytes. Pair mode reads the records' bytes once and
// writes 10 bytes a row and lane (two u8, two int32); step-input mode
// writes 8; single-stream mode 1; U reads 2 bytes a row and lane and
// writes the records' bytes (64k L3 block: 13.1 MB raw in, 65.5 MB out;
// 13.1 MB each way for U).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// Kernel L
// ---------------------------------------------------------------------------

enum { L_PAIR = 0, L_STEPS = 1, L_ONE = 2 };

constexpr int LT = 64;            // lanes a tile
constexpr int SUB = 32;           // rows a tile
constexpr int LTHREADS = 256;     // 8 warps: 4 walkers a lane
constexpr int WALKERS = LTHREADS / LT;
constexpr int WROWS = SUB / WALKERS;  // rows a walker takes of a tile
constexpr int SRCP = LT + 1;      // a row of source indices (words)
constexpr int STP = LT + 4;       // a row of a staged u8 tile (bytes)

struct LayoutArgs {
  const uint8_t* data;   // [Dp] (null in step-input mode)
  long long Dp;
  const int* off_s;      // [Rpl * W] per record, relative to data
  const int* off_q;      // QUAL's (pair mode)
  const int* lens;       // [Rpl * W] record lengths (0 past the records)
  const uint8_t* smap;   // [256]: SEQ's map (pair), the stream's or null
  int bias;              // subtracted from QUAL (pair) or the stream
  int Rpl, Sp, S, W;
  int nsub;              // tiles a CTA, down its lanes
  uint8_t* out_s;        // [Sp, W]: SEQ (pair) or the stream (one)
  uint8_t* out_q;        // QUAL (pair)
  int* pos;              // [Sp, W] (pair, step inputs)
  int* reset;
};

// bytes of a mode's shared memory, in the kernel's order
__host__ __device__ constexpr int smem_of(int mode) {
  return 256 + 4 * LT * 4                               // map, lane state
         + (mode == L_STEPS ? 0 : 4 * SUB * SRCP + SUB * STP)
         + (mode == L_PAIR ? 4 * SUB * SRCP + SUB * STP : 0)
         + (mode == L_ONE ? 0 : 4 * SUB * LT + SUB * STP);
}

__device__ __forceinline__ int clamp_src(long long x, long long Dp) {
  return (int)min(max(x, 0LL), Dp - 1);
}

// one staged u8 tile out to rows [s0, s0 + SUB) of out [Sp, W]
__device__ void store_u8(const LayoutArgs& a, const uint8_t* tile,
                         uint8_t* out, int s0, int w0) {
  constexpr int VR = LT / 16;  // vectors of 16 lanes a row
  if (a.W % 16 == 0) {
    const int r = threadIdx.x / VR, v = threadIdx.x % VR;
    if (r < SUB && s0 + r < a.Sp && w0 + 16 * v < a.W) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(tile) +
                          r * (STP / 4) + 4 * v;
      *reinterpret_cast<uint4*>(out + (size_t)(s0 + r) * a.W + w0 + 16 * v) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  for (int e = threadIdx.x; e < SUB * LT; e += LTHREADS) {
    const int r = e / LT, l = e % LT;
    if (s0 + r < a.Sp && w0 + l < a.W)
      out[(size_t)(s0 + r) * a.W + w0 + l] = tile[r * STP + l];
  }
}

// the staged pos and reset tiles out to rows [s0, s0 + SUB)
__device__ void store_steps(const LayoutArgs& a, const int* pos_t,
                            const uint8_t* rst_t, int s0, int w0) {
  constexpr int VR = LT / 4;  // vectors of 4 lanes a row
  if (a.W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < SUB * VR / LTHREADS; ++k) {
      const int e = k * LTHREADS + threadIdx.x;
      const int r = e / VR, v = e % VR;
      if (s0 + r >= a.Sp || w0 + 4 * v >= a.W) continue;
      const size_t at = (size_t)(s0 + r) * a.W + w0 + 4 * v;
      *reinterpret_cast<int4*>(a.pos + at) =
          *reinterpret_cast<const int4*>(pos_t + r * LT + 4 * v);
      const uint32_t b =
          reinterpret_cast<const uint32_t*>(rst_t)[r * (STP / 4) + v];
      *reinterpret_cast<int4*>(a.reset + at) =
          make_int4(b & 0xff, (b >> 8) & 0xff, (b >> 16) & 0xff, b >> 24);
    }
    return;
  }
  for (int e = threadIdx.x; e < SUB * LT; e += LTHREADS) {
    const int r = e / LT, l = e % LT;
    if (s0 + r >= a.Sp || w0 + l >= a.W) continue;
    const size_t at = (size_t)(s0 + r) * a.W + w0 + l;
    a.pos[at] = pos_t[r * LT + l];
    a.reset[at] = rst_t[r * STP + l];
  }
}

template <int MODE>
__global__ void __launch_bounds__(LTHREADS)
    lane_layout_kernel(const __grid_constant__ LayoutArgs a) {
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* map_t = sm;                                  // [256]
  int* own_j = reinterpret_cast<int*>(sm + 256);        // lane state [LT]
  int* own_st = own_j + LT;
  int* own_len = own_st + LT;
  int* own_ls = own_len + LT;
  uint8_t* p = sm + 256 + 4 * LT * 4;
  int *src_s = nullptr, *src_q = nullptr, *pos_t = nullptr;
  uint8_t *stage_s = nullptr, *stage_q = nullptr, *rst_t = nullptr;
  if (MODE != L_STEPS) {
    src_s = reinterpret_cast<int*>(p);
    p += 4 * SUB * SRCP;
    stage_s = p;
    p += SUB * STP;
  }
  if (MODE == L_PAIR) {
    src_q = reinterpret_cast<int*>(p);
    p += 4 * SUB * SRCP;
    stage_q = p;
    p += SUB * STP;
  }
  if (MODE != L_ONE) {
    pos_t = reinterpret_cast<int*>(p);
    p += 4 * SUB * LT;
    rst_t = p;
  }
  const int tid = threadIdx.x, t = tid & 31, warp = tid >> 5;
  const int w0 = blockIdx.y * LT;
  const int r0 = blockIdx.x * a.nsub * SUB;  // the CTA's first row
  if (MODE != L_STEPS && a.smap != nullptr && tid < 64)
    reinterpret_cast<uint32_t*>(map_t)[tid] =
        reinterpret_cast<const uint32_t*>(a.smap)[tid];

  // each lane's owner of row r0 (the last record j with cum_j <= r0) and
  // its last valid start at or before r0: a warp takes LPW lanes, 32
  // records of each a step, their lengths loaded and scanned side by side
  constexpr int LPW = LT / (LTHREADS / 32);
  const int lb = warp * LPW;
  if (t < LPW) own_ls[lb + t] = -1;
  __syncwarp();
  int basev[LPW];
  unsigned pending = 0;
#pragma unroll
  for (int i = 0; i < LPW; ++i) {
    basev[i] = 0;
    if (w0 + lb + i < a.W) pending |= 1u << i;
  }
  for (int jb = 0; pending != 0 && jb < a.Rpl; jb += 32) {
    const int j = jb + t;
    int len[LPW], inc[LPW];
#pragma unroll
    for (int i = 0; i < LPW; ++i)
      len[i] = inc[i] = (pending >> i & 1) && j < a.Rpl
                            ? a.lens[(size_t)j * a.W + w0 + lb + i] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive scans of the lengths
#pragma unroll
      for (int i = 0; i < LPW; ++i) {
        const int v = __shfl_up_sync(FULL, inc[i], o);
        if (t >= o) inc[i] += v;
      }
    }
#pragma unroll
    for (int i = 0; i < LPW; ++i) {
      const int st = basev[i] + inc[i] - len[i];
      // a prefix of the chunk (the starts do not decrease), never empty
      // at jb = 0 (cum_0 = 0)
      const unsigned le = __ballot_sync(FULL, j < a.Rpl && st <= r0);
      const unsigned vs = __ballot_sync(
          FULL, j < a.Rpl && len[i] > 0 && st <= r0 && st < a.S);
      const int k = 31 - __clz(le | 1u), kv = 31 - __clz(vs | 1u);
      const int ost = __shfl_sync(FULL, st, k);
      const int olen = __shfl_sync(FULL, len[i], k);
      const int ols = __shfl_sync(FULL, st, kv);
      basev[i] += __shfl_sync(FULL, inc[i], 31);
      if (t == 0 && (pending >> i & 1)) {
        if (le) {
          own_j[lb + i] = jb + k;
          own_st[lb + i] = ost;
          own_len[lb + i] = olen;
        }
        if (vs) own_ls[lb + i] = ols;
      }
      if (le != FULL || basev[i] > r0) pending &= ~(1u << i);
    }
  }
  __syncthreads();

  // the walkers: WALKERS threads a lane, walker q taking rows [q * WROWS,
  // (q + 1) * WROWS) of each tile; each carries the lane's owner j (start
  // st, length ln, offsets os/oq) down the rows, the next record's length
  // and offsets loaded ahead, and the last valid start ls
  const int lane = tid % LT, q = tid / LT;
  const int wl = w0 + lane;
  const bool live = wl < a.W;
  int j = 0, st = 0, ln = 0, os = 0, oq = 0, ls = -1;
  int nln = 0, nos = 0, noq = 0;
  if (live) {
    j = own_j[lane];
    st = own_st[lane];
    ln = own_len[lane];
    ls = own_ls[lane];
    const size_t at = (size_t)j * a.W + wl;
    if (MODE != L_STEPS) os = a.off_s[at];
    if (MODE == L_PAIR) oq = a.off_q[at];
    if (j + 1 < a.Rpl) {
      nln = a.lens[at + a.W];
      if (MODE != L_STEPS) nos = a.off_s[at + a.W];
      if (MODE == L_PAIR) noq = a.off_q[at + a.W];
    }
  }

  for (int sub = 0; sub < a.nsub; ++sub) {
    const int s0 = r0 + sub * SUB;
    if (s0 >= a.Sp) break;
    if (live) {
      for (int r = q * WROWS; r < (q + 1) * WROWS && s0 + r < a.Sp; ++r) {
        const int s = s0 + r;
        while (j + 1 < a.Rpl && st + ln <= s) {  // the next record owns s
          st += ln;
          ++j;
          ln = nln;
          os = nos;
          oq = noq;
          if (ln > 0 && st < a.S) ls = st;
          if (j + 1 < a.Rpl) {
            const size_t at = (size_t)(j + 1) * a.W + wl;
            nln = a.lens[at];
            if (MODE != L_STEPS) nos = a.off_s[at];
            if (MODE == L_PAIR) noq = a.off_q[at];
          }
        }
        if (MODE != L_STEPS)
          src_s[r * SRCP + lane] = clamp_src((long long)s - st + os, a.Dp);
        if (MODE == L_PAIR)
          src_q[r * SRCP + lane] = clamp_src((long long)s - st + oq, a.Dp);
        if (MODE != L_ONE) {
          pos_t[r * LT + lane] = s - max(ls, 0);
          rst_t[r * STP + lane] = ls == s;
        }
      }
    }
    __syncthreads();
    if (MODE != L_STEPS) {
      // a warp gathers 32 rows of one lane: neighbouring source bytes
      constexpr int K = SUB * LT / LTHREADS;
      uint8_t b[K], qb[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = k * LTHREADS + tid;
        const int l = e >> 5, r = e & 31;
        const bool in = w0 + l < a.W && s0 + r < a.Sp;
        b[k] = in ? __ldg(a.data + src_s[r * SRCP + l]) : 0;
        if (MODE == L_PAIR)
          qb[k] = in ? __ldg(a.data + src_q[r * SRCP + l]) : 0;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = k * LTHREADS + tid;
        const int l = e >> 5, r = e & 31;
        if (MODE == L_PAIR) {
          stage_s[r * STP + l] = map_t[b[k]];
          stage_q[r * STP + l] = (uint8_t)(qb[k] - a.bias);
        } else {
          stage_s[r * STP + l] =
              a.smap != nullptr ? map_t[b[k]] : (uint8_t)(b[k] - a.bias);
        }
      }
      __syncthreads();
      store_u8(a, stage_s, a.out_s, s0, w0);
      if (MODE == L_PAIR) store_u8(a, stage_q, a.out_q, s0, w0);
    }
    if (MODE != L_ONE) store_steps(a, pos_t, rst_t, s0, w0);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Kernel U
// ---------------------------------------------------------------------------

struct UnpackArgs {
  const uint8_t* seq;      // [Sp, W]: SEQ (pair) or the stream (one)
  const uint8_t* qual;     // QUAL (pair)
  const int* offs;         // [n] per record: its first output byte
  const int* lens;         // [n]
  long long n, Sp, total;
  int W;
  const uint8_t* smap;     // [256]: SEQ's map (pair), the stream's or null
  int qbias;               // added to QUAL (pair) or the stream
  uint8_t* seq_out;        // [total] (pair) or [Tp] (one)
  uint8_t* qual_out;
  long long Tp;            // single-stream mode: the output's length
};

// Kernel U: one CTA per tile of UT rows x 32 lanes. Its warps first
// stage the tile's SEQ and QUAL bytes in shared memory, each row of 32
// lanes one coalesced 32-byte load; then each warp takes 4 of the lanes
// and writes their records' bytes in record order, 32 consecutive bytes a
// store. A lane's records are found 32 at a time: the warp loads 32
// lengths side by side and scans them (a record's start is the sum of
// the lane's lengths before it), so no thread walks the records one by
// one. Single-stream mode (PAIR false) writes one stream and fills the
// output's bytes past `total`.
constexpr int UT = 128;       // rows a tile
constexpr int UPAD = UT + 4;  // a lane's row of the staged tile, padded
constexpr int UWARPS = 8;

template <bool PAIR>
__global__ void __launch_bounds__(32 * UWARPS)
    lane_unpack_kernel(const __grid_constant__ UnpackArgs a) {
  __shared__ uint8_t ts[32][UPAD], tq[PAIR ? 32 : 1][UPAD];
  const int t = threadIdx.x, warp = threadIdx.y;
  const long long s0 = (long long)blockIdx.x * UT;
  const int w0 = blockIdx.y * 32;
  const int rows = (int)min((long long)UT, a.Sp - s0);
  const long long s1 = s0 + rows;
  if (!PAIR) {  // bytes past the records: the zero byte through the map
    const uint8_t fill = a.smap != nullptr ? a.smap[0] : (uint8_t)a.qbias;
    const long long cta = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    const long long stride = (long long)gridDim.x * gridDim.y * 32 * UWARPS;
    for (long long o = a.total + cta * 32 * UWARPS + warp * 32 + t; o < a.Tp;
         o += stride)
      a.seq_out[o] = fill;
  }
  if (w0 + t < a.W) {
    for (int r = warp; r < rows; r += UWARPS) {
      const size_t at = (size_t)(s0 + r) * a.W + w0 + t;
      ts[t][r] = a.seq[at];
      if (PAIR) tq[t][r] = a.qual[at];
    }
  }
  __syncthreads();
  const long long Rpl = (a.n + a.W - 1) / a.W;
  for (int l = warp; l < 32 && w0 + l < a.W; l += UWARPS) {
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
          const uint8_t v = ts[l][x - s0];
          if (PAIR) {
            a.seq_out[o] = a.smap[v];
            a.qual_out[o] = (uint8_t)((int)tq[l][x - s0] + a.qbias);
          } else {
            a.seq_out[o] = a.smap != nullptr ? a.smap[v]
                                             : (uint8_t)((int)v + a.qbias);
          }
        }
      }
      base += __shfl_sync(FULL, inc, 31);
    }
  }
}

// per card: its SM count and each mode's resident CTAs an SM (0: not yet
// asked); the values do not change, so racing writers write the same
constexpr int MAX_DEVICES = 64;
int sms_of[MAX_DEVICES];
int per_sm_of[3][MAX_DEVICES];

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel L over one block. mode 0 (pair): seq, qual, pos and reset from
// `data` through off_s/off_q, smap and bias; mode 1 (step inputs): pos and
// reset; mode 2 (single stream): seq from `data` through off_s and smap,
// or minus bias where smap is null. lens, off_s and off_q hold Rpl * W
// entries.
int lane_layout(int mode, const uint8_t* data, long long Dp,
                const int* off_s, const int* off_q, const int* lens,
                const uint8_t* smap, int bias, int Rpl, int Sp, int S, int W,
                uint8_t* seq, uint8_t* qual, int* pos, int* reset,
                cudaStream_t stream) {
  if (W < 1 || Sp < 1 || Rpl < 1 || mode < 0 || mode > 2 ||
      (mode != L_STEPS && Dp < 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int lane_tiles = (W + LT - 1) / LT;
  const long long tiles = (Sp + SUB - 1) / SUB;
  auto go = [&](auto kern, int bytes) -> int {
    // the card's SMs and the mode's CTAs an SM, asked once a card (the
    // shared-memory attribute is set with them)
    int& sms = sms_of[dev];
    int& per_sm = per_sm_of[mode][dev];
    if (per_sm == 0 || sms == 0) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      int n = 0, m = 0;
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m, kern,
                                                            LTHREADS, bytes);
      if (err != cudaSuccess) return (int)err;
      sms = max(n, 1);
      per_sm = max(m, 1);
    }
    // one wave of CTAs: each lane tile's rows split over as many CTAs as
    // the card holds at once over the lane tiles, each CTA walking down
    // `nsub` tiles of its lanes (a few on a short block, hundreds on a long)
    const long long cols = max(1LL, (long long)sms * per_sm / lane_tiles);
    const int nsub = (int)((tiles + cols - 1) / cols);
    const LayoutArgs a{data, Dp, off_s, off_q, lens, smap, bias, Rpl, Sp, S,
                       W, nsub, seq, qual, pos, reset};
    const dim3 grid((unsigned)((tiles + nsub - 1) / nsub),
                    (unsigned)lane_tiles);
    kern<<<grid, LTHREADS, bytes, stream>>>(a);
    return (int)cudaGetLastError();
  };
  if (mode == L_PAIR) return go(lane_layout_kernel<L_PAIR>, smem_of(L_PAIR));
  if (mode == L_STEPS)
    return go(lane_layout_kernel<L_STEPS>, smem_of(L_STEPS));
  return go(lane_layout_kernel<L_ONE>, smem_of(L_ONE));
}

// Kernel U over one block: pair mode where `qual` is given (seq_out and
// qual_out [total]), single-stream mode otherwise (seq_out [Tp], through
// smap or plus qbias where smap is null).
int lane_unpack(const uint8_t* seq, const uint8_t* qual, const int* offs,
                const int* lens, long long n, long long Sp, long long total,
                int W, const uint8_t* smap, int qbias, uint8_t* seq_out,
                uint8_t* qual_out, long long Tp, cudaStream_t stream) {
  if (W < 1 || Sp < 1 || n < 0 || (qual != nullptr && smap == nullptr))
    return (int)cudaErrorInvalidValue;
  const UnpackArgs a{seq, qual, offs, lens, n, Sp, total, W, smap, qbias,
                     seq_out, qual_out, Tp};
  const dim3 grid((unsigned)((Sp + UT - 1) / UT), (unsigned)((W + 31) / 32));
  if (qual != nullptr)
    lane_unpack_kernel<true><<<grid, dim3(32, UWARPS), 0, stream>>>(a);
  else
    lane_unpack_kernel<false><<<grid, dim3(32, UWARPS), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
