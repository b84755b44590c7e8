// K1: all-pairs Hamming distance of packed 256-bit ORB descriptors, on the
// tensor cores.
//
// Replaces the TPU kernel sqrtlm_slam_tpu/ops/hamming.py::hamming_matrix_pallas
// (body `_kernel`): out[q, t] = sum_w popcount(desc_q[q, w] ^ desc_t[t, w])
// over the 8 32-bit words, (Q, 8) x (T, 8) -> (Q, T) int32 in [0, 256].
//
// Arithmetic: each bit b becomes s = 1 - 2b in int8 (+1 or -1). For two
// descriptors the dot product of their 256 signs is (#equal - #different)
// = 256 - 2 * hamming, exact in int32, so out = (256 - dot) >> 1. The dot is
// an int8 matrix product: mma.sync m16n8k32 (s8 x s8 -> s32), 8 k-steps of
// 32 bits. Any bijection of bits onto the k axis gives the same dot, as long
// as A and B use the same one: here bit j of word w is k = 32 w + j.
//
// What bounds it on Hopper: the (Q, T) int32 output write (2048 x 2000 ->
// 16.4 MB, 4.9 us at 3.35 TB/s). The int8 products (2 Q T 256 operations,
// 1.1 us at 1,979 TOP/s) are not the limit; the CUDA-core popcount of the
// first port was (16 per clock per SM).
//
// Design: one 128 x 128 output tile per block of 8 warps (2 along Q x 4
// along T, warp tile 64 x 32: 4 x 4 mma tiles). The block loads its 128 + 128
// packed rows (32 bytes each) with 16-byte read-only loads and expands every
// nibble to 4 sign bytes straight into shared memory, in the order the
// fragments are read: for row r and word w, thread tq of a quad reads one
// 8-byte pair (nibble tq, nibble tq + 4) -- bits 4tq..4tq+3 and 16+4tq.. of
// the word, which are k columns 4tq.. and 16+4tq.. of mma's A (and B)
// fragment. Pairs of a row are rotated by the row index, so the 8-byte
// fragment loads and the expansion stores are free of bank conflicts. The
// signs never reach device memory. The epilogue swaps half of each
// accumulator fragment with the neighbouring lane, so that every lane holds
// 4 consecutive outputs of one row, and writes them with one 16-byte store
// (scalar stores where T is not a multiple of 4 or at the ragged edge). Q and
// T are masked in the kernel; the inputs are not padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kTile = 128;              // output rows and columns per block
constexpr int kThreads = 256;           // 8 warps
constexpr int kRowWords = kWords * 8;   // expanded row: 64 words (256 sign bytes)
constexpr int kSmemBytes = 2 * kTile * kRowWords * 4;  // A and B tiles: 64 KB

// Bits 0..3 of v -> bytes 0..3: a set bit gives -1 (0xFF), a clear bit +1.
__device__ __forceinline__ uint32_t expand_nibble(uint32_t v) {
  const uint32_t m = (v * 0x00204081u) & 0x01010101u;  // bit i -> bit 8i
  return (m * 0xFEu) | 0x01010101u;
}

// Word offset of the (nibble tq, nibble tq + 4) pair of word w in row r.
__device__ __forceinline__ int pair_offset(int r, int w, int tq) {
  return r * kRowWords + ((w + r) & 7) * 8 + tq * 2;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Expand the 128 rows of one operand tile, 64 per pass: thread (row, tq)
// writes the 8 pairs of its nibble position, one per word.
__device__ __forceinline__ void expand_rows(const uint32_t* __restrict__ src, int n_rows,
                                            int row0, uint32_t* dst, int tid) {
  const int tq = tid & 3;
#pragma unroll
  for (int pass = 0; pass < kTile / (kThreads / 4); ++pass) {
    const int r = (tid >> 2) + pass * (kThreads / 4);
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (row0 + r < n_rows) {
      const uint4* p = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kWords);
      lo = __ldg(p);
      hi = __ldg(p + 1);
    }
    const uint32_t words[kWords] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t x = words[w] >> (4 * tq);
      *reinterpret_cast<uint2*>(dst + pair_offset(r, w, tq)) =
          make_uint2(expand_nibble(x & 0xFu), expand_nibble((x >> 16) & 0xFu));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
hamming_mma_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                   int32_t* __restrict__ out, int Q, int T) {
  extern __shared__ uint4 smem[];
  uint32_t* sA = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sB = sA + kTile * kRowWords;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  expand_rows(q, Q, m0, sA, tid);
  expand_rows(t, T, n0, sB, tid);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 64;   // warp's first row in the tile
  const int wn = (warp >> 1) * 32;  // warp's first column in the tile
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = wm + mi * 16 + g;
      const uint2 top = *reinterpret_cast<const uint2*>(sA + pair_offset(r, w, tq));
      const uint2 bot = *reinterpret_cast<const uint2*>(sA + pair_offset(r + 8, w, tq));
      a[mi][0] = top.x;  // row g,     k 4tq..4tq+3
      a[mi][1] = bot.x;  // row g + 8, k 4tq..4tq+3
      a[mi][2] = top.y;  // row g,     k 16+4tq..
      a[mi][3] = bot.y;  // row g + 8, k 16+4tq..
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint2 v = *reinterpret_cast<const uint2*>(sB + pair_offset(wn + ni * 8 + g, w, tq));
      b[ni][0] = v.x;  // k 4tq..4tq+3 of column g
      b[ni][1] = v.y;  // k 16+4tq..
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }

  // Accumulator fragment: c0, c1 at (row g, cols 2tq, 2tq+1), c2, c3 at row
  // g + 8. An even lane keeps row g and takes its odd neighbour's row-g pair;
  // the odd lane keeps row g + 8: each lane then holds 4 consecutive columns.
  const bool odd = tq & 1;
  const bool vec = (T & 3) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      int v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = (256 - acc[mi][ni][c]) >> 1;
      const int s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const int s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      const int4 o = odd ? make_int4(s0, s1, v[2], v[3]) : make_int4(v[0], v[1], s0, s1);
      const int row = m0 + wm + mi * 16 + g + (odd ? 8 : 0);
      const int col = n0 + wn + ni * 8 + 2 * (tq & 2);
      if (row >= Q) continue;
      int32_t* dst = out + (size_t)row * T + col;
      if (vec && col + 3 < T) {
        *reinterpret_cast<int4*>(dst) = o;
      } else {
        if (col < T) dst[0] = o.x;
        if (col + 1 < T) dst[1] = o.y;
        if (col + 2 < T) dst[2] = o.z;
        if (col + 3 < T) dst[3] = o.w;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). Both
// descriptor arrays must be 16-byte aligned (the wrapper checks).
extern "C" int hamming_launch(const void* desc_q, const void* desc_t, void* out,
                              int Q, int T, void* stream) {
  if (Q <= 0 || T <= 0) return 0;
  // The 64 KB of dynamic shared memory need an opt-in, once per device.
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(hamming_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  const dim3 grid((T + kTile - 1) / kTile, (Q + kTile - 1) / kTile);
  hamming_mma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc_q), static_cast<const uint32_t*>(desc_t),
      static_cast<int32_t*>(out), Q, T);
  return static_cast<int>(cudaGetLastError());
}
