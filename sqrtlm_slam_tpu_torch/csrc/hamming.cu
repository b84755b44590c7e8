// K1: all-pairs Hamming distance of packed 256-bit ORB descriptors.
//
// Replaces the TPU kernel sqrtlm_slam_tpu/ops/hamming.py::hamming_matrix_pallas
// (body `_kernel`): out[q, t] = sum_w popcount(desc_q[q, w] ^ desc_t[t, w])
// over the 8 32-bit words, (Q, 8) x (T, 8) -> (Q, T) int32 in [0, 256].
//
// What bounds it on Hopper: the (Q, T) int32 output write. Each output
// element costs 8 XOR + 8 POPC on 64 bytes of operands that are reused T
// (resp. Q) times, so with the operands staged in shared memory the kernel
// is bound by storing 4 bytes per element (2048 x 2000 -> 16 MB, ~5 us at
// 3.35 TB/s) plus launch latency at the main path's sizes.
//
// Design: one block per 32 x 32 output tile, 256 threads. The block stages
// its 32 query rows and 32 target rows (8 words each, one word per thread)
// in shared memory; each thread keeps one target row in registers and
// produces 4 outputs of one column. A warp shares one query row (broadcast
// reads) and writes 32 consecutive int32 outputs (coalesced). The target
// tile is padded to 9 words per row so the per-column reads are free of bank
// conflicts. The ragged edge is masked in the kernel: no padding of Q or T
// (the TPU wrapper padded both to multiples of 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kWords = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
               int32_t* __restrict__ out, int Q, int T) {
  __shared__ uint32_t sq[kTile][kWords];
  __shared__ uint32_t st[kTile][kWords + 1];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int t0 = blockIdx.x * kTile;

  const int r = tid / kWords;
  const int w = tid % kWords;
  sq[r][w] = (q0 + r < Q) ? q[(size_t)(q0 + r) * kWords + w] : 0u;
  st[r][w] = (t0 + r < T) ? t[(size_t)(t0 + r) * kWords + w] : 0u;
  __syncthreads();

  const int tc = tid % kTile;
  const int tr0 = tid / kTile;
  uint32_t tw[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) tw[k] = st[tc][k];

  const int col = t0 + tc;
#pragma unroll
  for (int i = 0; i < kTile / (kThreads / kTile); ++i) {
    const int tr = tr0 + i * (kThreads / kTile);
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) acc += __popc(sq[tr][k] ^ tw[k]);
    const int row = q0 + tr;
    if (row < Q && col < T) out[(size_t)row * T + col] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int hamming_launch(const void* desc_q, const void* desc_t, void* out,
                              int Q, int T, void* stream) {
  if (Q <= 0 || T <= 0) return 0;
  dim3 grid((T + kTile - 1) / kTile, (Q + kTile - 1) / kTile);
  hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc_q), static_cast<const uint32_t*>(desc_t),
      static_cast<int32_t*>(out), Q, T);
  return static_cast<int>(cudaGetLastError());
}
