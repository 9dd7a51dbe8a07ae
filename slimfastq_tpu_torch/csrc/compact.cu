// Emission compaction: Kernel C (compact_lanes).
//
// Replaces: slimfastq_tpu/ops/compact_pallas.py `_build` and `_build_v2`
// (the Pallas compactors, grid W/8 x NC with a roll+mask read-modify-write
// into a VMEM row) and slimfastq_tpu/ops/compact_xla.py `_build` (the
// default TPU compactor: scatter of chunk starts, cumsum, two gathers).
//
// Contract (compact_xla.compact_host_reference): the encode coder leaves
// each lane's renorm bytes in dense per-chunk windows ebufs [NC, W, CB] u8
// with per-chunk valid counts eptrs [NC, W]; per lane, concatenate each
// chunk's valid prefix at the lane's exclusive prefix offset into
// payload [W, Bmax] u8 and return the lane totals [W]. Bytes past a lane's
// total are written as 0 (the TPU versions leave them unspecified), so the
// kernel and its plain PyTorch version agree on every byte.
//
// Design: one CTA per lane, 256 threads. The CTA walks the lane's NC
// chunk counts in tiles of 256: a shared-memory scan gives every chunk its
// offset, then each thread copies its chunk's valid prefix (a few bytes;
// CB is 32-160). No Pallas tiling carries over: blocks run in parallel,
// so the running offset is a loop carry inside the CTA, not a grid carry.
//
// Bound on the H100: device-memory bytes. The data needs only the valid
// bytes (sum of eptrs), the [NC, W] counts and the [W, Bmax] output; at
// the L3 64k-record block that is a few MB, microseconds at 3.35 TB/s.
// The byte-wise copies are uncoalesced (lane rows are CB bytes apart), so
// the kernel sits well above that bound; vectorised copies, or per-lane
// direct emission in Kernel E that removes this kernel, are queued work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 256;

__global__ void compact_lanes_kernel(const uint8_t* __restrict__ ebufs,
                                     const int* __restrict__ eptrs, int NC,
                                     int W, int CB, int Bmax,
                                     uint8_t* __restrict__ out,
                                     int* __restrict__ totals) {
  __shared__ int scan[T];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  uint8_t* orow = out + (size_t)w * Bmax;
  int base = 0;  // bytes of this lane before the current tile
  for (int c0 = 0; c0 < NC; c0 += T) {
    const int c = c0 + tid;
    const int k = c < NC ? eptrs[(size_t)c * W + w] : 0;
    scan[tid] = k;
    __syncthreads();
    for (int s = 1; s < T; s <<= 1) {  // inclusive Hillis-Steele scan
      const int v = tid >= s ? scan[tid - s] : 0;
      __syncthreads();
      scan[tid] += v;
      __syncthreads();
    }
    const int off = base + scan[tid] - k;
    const uint8_t* src = ebufs + ((size_t)c * W + w) * CB;
    const int keep = min(k, CB);
    for (int b = 0; b < k; ++b) {
      const int o = off + b;
      if (o < Bmax) orow[o] = b < keep ? src[b] : 0;
    }
    base += scan[T - 1];
    __syncthreads();  // scan[] is rewritten by the next tile
  }
  for (int o = base + tid; o < Bmax; o += T) orow[o] = 0;
  if (tid == 0) totals[w] = base;
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int compact_lanes(const uint8_t* ebufs, const int* eptrs, int NC, int W,
                  int CB, int Bmax, uint8_t* out, int* totals,
                  cudaStream_t stream) {
  compact_lanes_kernel<<<W, T, 0, stream>>>(ebufs, eptrs, NC, W, CB, Bmax,
                                            out, totals);
  return (int)cudaGetLastError();
}

}  // extern "C"
