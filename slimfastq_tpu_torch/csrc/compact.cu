// Emission compaction: Kernel C (compact_streams).
//
// Replaces: slimfastq_tpu/ops/compact_pallas.py `_build` and `_build_v2`
// (the Pallas compactors, grid W/8 x NC with a roll+mask read-modify-write
// into a VMEM row) and slimfastq_tpu/ops/compact_xla.py `_build` (the
// default TPU compactor: scatter of chunk starts, cumsum, two gathers).
//
// Contract, per stream (compact_xla.compact_host_reference): the encode
// coder leaves each lane's renorm bytes in dense per-chunk windows
// ebufs [NC, W, CB] u8 with per-chunk valid counts eptrs [NC, W]; per lane,
// concatenate each chunk's valid prefix at the lane's exclusive prefix
// offset into payload [W, Bmax] u8 and return the lane totals [W]. A count
// past CB (an overflowed optimistic window) advances the offset by the
// whole count and its bytes past CB are written as 0. Bytes past a lane's
// total are written as 0 (the TPU versions leave them unspecified), so the
// kernel and its plain PyTorch version agree on every byte. The rows sit
// at a pitch of Bmax rounded up to 16 bytes, zero past Bmax.
//
// Design: one launch compacts every coded stream of an encode block, or of
// a window of blocks (the small-block window path codes a window's blocks
// together). The streams' descriptors ride in a __grid_constant__
// parameter block (kernel parameters rather than a descriptor array in
// device memory: no upload and no allocation per launch); the
// grid is (lane group, stream). A CTA owns 8 adjacent lanes of one stream
// (a 1,024-lane stream spreads over 128 CTAs, so the block's launch fills
// the card) and walks the chunks in tiles of 128. Each thread loads the
// counts of 4 chunks of its lane one tile ahead (32-byte rows, one sector
// each) and, as soon as a tile starts, the first 16-byte word of each
// non-empty window (CB is a multiple of 16, so every window starts
// aligned; the 8 lanes of a chunk are one span of 8 * CB bytes). The
// tile's counts go to shared memory, where warp j turns lane j's into
// exclusive offsets with warp shuffles plus a running carry: no
// block-wide scan, two barriers a tile. The window bytes then go into the
// lanes' rows in shared memory, and each row leaves as coalesced 16-byte
// stores, zero tail included. A row longer than the stage (SEG_MAX bytes
// a lane) is staged in segments; each segment walks the counts again and
// places only the bytes that land in it.
//
// Bound on the H100: device-memory bytes. The function needs the valid
// bytes, the [NC, W] counts, the [W, pitch] rows and the totals; for the
// level-3 64k-record block a few MB, microseconds at 3.35 TB/s. Reads move
// in 32-byte sectors and a chunk holds about 2 valid bytes of its window,
// so each non-empty window costs a sector: that traffic, set by the
// coder's window layout, keeps the kernel above the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 8;                // lanes per CTA: a 32-byte row
constexpr int SLOTS = 32;               // chunks a tile step takes at once
constexpr int THREADS = LANES * SLOTS;  // 8 warps
constexpr int PER = 4;                  // tile steps: chunks per thread
constexpr int TILE = SLOTS * PER;       // chunks per tile
constexpr int CPITCH = LANES + 1;       // ints per count row, padded
constexpr int CNT_BYTES = 2 * TILE * CPITCH * 4;  // double-buffered tile
constexpr int SMEM_MAX = 232448;        // a CTA's shared memory on sm_90
constexpr int SEG_MAX = (SMEM_MAX - CNT_BYTES) / LANES / 16 * 16;  // 27904
// descriptors a launch (compact_torch's MAX_STREAMS too): a window of 8 L4
// blocks with their match trials codes 88 streams, 56 bytes each, past the
// classic 4 KB of kernel parameters; CUDA >= 12.1 passes up to 32 KB
constexpr int MAX_STREAMS = 256;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS / 32 == LANES, "warp j scans, zeroes and stores lane j");

struct Desc {
  const uint8_t* ebufs;  // [NC, W, CB], 16-byte aligned
  const int* eptrs;      // [NC, W]
  uint8_t* out;          // [W, pitch], 16-byte aligned
  int* totals;           // [W]
  int NC, W, CB, Bmax, pitch;
};

struct Params {
  Desc d[MAX_STREAMS];
  int seg;  // bytes of each lane row staged at once: a multiple of 16
};

__device__ __forceinline__ uint8_t byte_of(const uint4& v, int b) {
  const uint32_t x = b < 8 ? (b < 4 ? v.x : v.y) : (b < 12 ? v.z : v.w);
  return (uint8_t)(x >> ((b & 3) * 8));
}

// Thread (slot q, lane l) owns chunks c0 + q + SLOTS * u of a tile at lane
// w0 + l: a warp's count loads are four 32-byte rows and its window loads
// four spans of LANES * CB bytes. Warp j takes lane j's offsets over the
// tile (thread t: chunks t + 32u) from the tile's counts in shared memory.
__global__ void __launch_bounds__(THREADS)
    compact_streams_kernel(const __grid_constant__ Params p) {
  const Desc& d = p.d[blockIdx.y];
  const int w0 = blockIdx.x * LANES;
  if (w0 >= d.W) return;  // the stream has fewer lane groups than the grid
  extern __shared__ __align__(16) uint8_t smem[];
  int* cnt = reinterpret_cast<int*>(smem);
  uint8_t* stage = smem + CNT_BYTES;  // [LANES][seg]: the lanes' rows
  const int q = threadIdx.x / LANES;
  const int l = threadIdx.x % LANES;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int w = w0 + l;
  const bool live = w < d.W;
  const int nl = min(LANES, d.W - w0);
  const int seg = min(p.seg, d.pitch);
  uint8_t* row = stage + l * seg;  // lane w's row
  uint4* wrow = reinterpret_cast<uint4*>(stage + warp * seg);  // lane w0+warp
  const int ntiles = (d.NC + TILE - 1) / TILE;
  const uint8_t* lane_bufs = d.ebufs + (size_t)w * d.CB;

  for (int seg0 = 0; seg0 < d.pitch; seg0 += seg) {
    const int words = min(seg, d.pitch - seg0) / 16;
    const int lim = min(seg0 + seg, d.Bmax) - seg0;  // stage bytes kept
    for (int j = t; warp < nl && j < words; j += 32)
      wrow[j] = make_uint4(0, 0, 0, 0);
    int k[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = q + SLOTS * u;
      k[u] = live && c < d.NC ? __ldg(d.eptrs + (size_t)c * d.W + w) : 0;
    }
    int carry = 0;  // lane w0 + warp's bytes before this tile
    for (int i = 0; i < ntiles; ++i) {
      int* buf = cnt + (i & 1) * TILE * CPITCH;
      const int c0 = i * TILE;
      // the first word of each non-empty window, in flight over the scan
      uint4 v[PER];
      int n[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int c = c0 + q + SLOTS * u;
        n[u] = k[u];
        v[u] = n[u] > 0 ? __ldg(reinterpret_cast<const uint4*>(
                              lane_bufs + (size_t)c * d.W * d.CB))
                        : make_uint4(0, 0, 0, 0);
        buf[(q + SLOTS * u) * CPITCH + l] = n[u];
      }
      // the buffer written above was last read two tiles ago, before
      // every warp reached the previous tile's barriers
      __syncthreads();
      if (i + 1 < ntiles) {
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int c = c0 + TILE + q + SLOTS * u;
          k[u] = live && c < d.NC ? __ldg(d.eptrs + (size_t)c * d.W + w)
                                  : 0;
        }
      }
      if (warp < nl) {  // lane w0 + warp: exclusive offsets, in place
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          int* at = buf + (t + SLOTS * u) * CPITCH + warp;
          const int m = *at;
          int incl = m;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(FULL, incl, o);
            if (t >= o) incl += x;
          }
          *at = carry + incl - m - seg0;  // the chunk's start in the stage
          carry += __shfl_sync(FULL, incl, 31);
        }
      }
      __syncthreads();
      // window bytes [max(0, -o), e) of each chunk land at row[o + ...]
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int o = buf[(q + SLOTS * u) * CPITCH + l];
        const int e = min(min(n[u], d.CB), lim - o);
        const uint4* win = reinterpret_cast<const uint4*>(
            lane_bufs + (size_t)(c0 + q + SLOTS * u) * d.W * d.CB);
        uint4 x = v[u];
        int j = 0;
        for (int b = max(0, -o); b < e; ++b) {
          if (b >> 4 != j) x = __ldg(win + (j = b >> 4));
          row[o + b] = byte_of(x, b & 15);
        }
      }
    }
    __syncthreads();  // every row is placed
    if (warp < nl) {
      uint4* dst = reinterpret_cast<uint4*>(
          d.out + (size_t)(w0 + warp) * d.pitch + seg0);
      for (int j = t; j < words; j += 32) dst[j] = wrow[j];
      if (seg0 == 0 && t == 0) d.totals[w0 + warp] = carry;
    }
    __syncthreads();  // the rows are read before the next segment's zeros
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch over n stream descriptors (an array of Desc: a parameter of
// a type in the anonymous namespace would take the entry's C linkage
// away), at least one with a lane.
int compact_streams(const void* descs, int n, cudaStream_t stream) {
  if (n < 1 || n > MAX_STREAMS) return (int)cudaErrorInvalidValue;
  Params p = {};
  int groups = 0, seg = 16;
  for (int i = 0; i < n; ++i) {
    const Desc& d = static_cast<const Desc*>(descs)[i];
    if (d.CB % 16 || d.pitch % 16 || d.pitch < d.Bmax || d.Bmax < 1 ||
        (uintptr_t)d.ebufs % 16 || (uintptr_t)d.out % 16)
      return (int)cudaErrorInvalidValue;
    p.d[i] = d;
    groups = max(groups, (d.W + LANES - 1) / LANES);
    seg = max(seg, min(d.pitch, SEG_MAX));
  }
  if (groups == 0) return (int)cudaErrorInvalidValue;
  p.seg = seg;
  const int smem = CNT_BYTES + LANES * seg;
  const cudaError_t err = cudaFuncSetAttribute(
      compact_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  compact_streams_kernel<<<dim3(groups, n), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
