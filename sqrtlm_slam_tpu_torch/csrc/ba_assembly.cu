// K2: bucketed bundle-adjustment assembly (residuals, Jacobians, Huber IRLS
// weights and every reduction the sqrt-Schur step needs).
//
// Replaces the TPU kernel sqrtlm_slam_tpu/optim/assembly_pallas.py::_assemble_raw
// (body `_kernel`). Per (landmark l, slot k) with camera c = obs_cam[l, k]:
//   x_c = R_c X_l + t_c; stereo residual r = [u, v, u_r] - uvr (3rd row
//   masked when uvr[2] < 0, i.e. mono); Jp (3x6, zeroed for fixed poses),
//   Jl (3x3); e2 = w_active * |r|^2; Huber IRLS weight on e2 (optional).
// Outputs, all float32:
//   Hll (L,3,3) = sum_k Jl^T w Jl      bl (L,3) = sum_k Jl^T w r
//   U (L,K,6,3) = Jp^T w Jl per slot   chi2 = sum rho(e2)
//   Hpp (P,6,6) = sum over slots of camera p of Jp^T w Jp, bp (P,6) = Jp^T w r
//
// What bounds it on Hopper: bytes. Per slot ~600 FLOP against ~20 bytes of
// input and 72 bytes of U output, so the least time is the U write (L*K*72
// bytes: 3.3 MB at (L, K) = (8192, 5), 60 MB at (120000, 7)) over the
// memory rate. The hard part is the camera-keyed sum: the TPU kernel carried
// Hpp/bp in one VMEM accumulator across its *sequential* grid; Hopper
// blocks run in parallel and in no order.
//
// Design: two passes on one stream. No float is reduced by an atomic, so
// every sum has a fixed order and runs are bit-for-bit repeatable (an LM
// accept test at gain ratio ~0 flips on float32 reassociation).
//  1. Landmark pass (landmark-major): one thread per landmark loops over its
//     K slots, reading poses through the read-only cache (they stay in L2),
//     keeping Hll, bl and its chi2 in registers. The slots go in chunks of
//     C = ceil(K / ceil(K / 16)) (one chunk up to K = 16): the block stages
//     a chunk's U rows of its 128 landmarks in shared memory (one padding
//     float every 32, so the per-slot writes spread over the banks) and
//     writes them out before the next chunk; then Hll and bl. With one chunk
//     the block's U rows are one contiguous span, written with 16-byte
//     stores; with more, each landmark's chunk is a contiguous span of C * 72
//     bytes, written with 8-byte stores. Shared memory depends on C only
//     (at most 152 KB), not on K or P, so any K runs. Hll, bl and chi2 are
//     summed in slot order across the chunks. The block is one chi2 tile
//     (below) and writes its tile partial. One chunk and several are two
//     instances of the kernel (and of K3): one shared chunk loop cost the
//     one-chunk case up to 6 % of its device time (PERF.md, section 6).
//  2. Camera pass (camera-major): one block per camera walks that camera's
//     slots from the compressed slot table of optim/segment.py (members in
//     their order in the data), recomputes each slot's Jp, r and w, and
//     accumulates the 21 + 6 independent Hpp/bp entries in registers with a
//     fixed stride of 256 slots per thread; then a fixed-shape warp-shuffle
//     tree and a sum over the 8 warps in warp order. A fixed camera's rows
//     are zeros. Slots not in the table are inactive (w = 0) and would add
//     exact zeros. One extra block sums the tile partials into the chi2
//     total. No pose cap: nothing here scales with P but the grid.
//
// The chi2 order, shared by K2 and K3 and defined per tile of 128 landmarks
// whatever the grid: a thread sums its landmark's K slots in slot order;
// `tile_sum` adds the 128 values by a fixed warp-shuffle tree in each warp,
// then the 4 warp sums in warp order (one partial per tile); `total_sum` has
// lane t of 128 add the partials t, t + 128, ... in index order, then the
// same tree. Every pass computes a slot through one function, `slot_terms`,
// whose residual, weight and loss use explicitly rounded operations (no FMA
// contraction that could differ between instantiations), so K3's chi2 is
// bitwise equal to K2's and a slot's w is the same in both K2 passes.
//
// K3 (chi2 only) replaces the TPU kernel assembly_pallas.py::chi2_prepared
// (body `_chi2_kernel`), the residual-only robust chi2 of the LM candidate
// test. Bound: bytes, ~20 read per slot (18 MB at (L, K) = (120000, 7)),
// ~45 FLOP per slot. One launch, one block per tile: the block's threads
// evaluate the tile's slots in flat order (coalesced observation reads;
// in chunks of at most 64 slots per landmark, so the staged costs take at
// most 32 KB of shared memory at any K) and
// read the poses through the read-only cache and L2 (nothing staged, so no
// pose cap: only the poses a tile hits are read); the block that finishes
// last (an integer ticket, after a fence) sums the tile partials by tile
// index, so the order of arrival does not enter the float order. Measured
// against this (PERF.md): one thread per landmark reading its own
// slots, and staging a tile's observation spans in shared memory by 16-byte
// loads or by `cp.async.bulk` (one or two stages) were all slower; the
// gathers of the poses and the slot arithmetic, not the observation bytes,
// set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLmThreads = 128;   // landmarks per chi2 tile (a landmark-pass or K3 block)
constexpr int kLmWarps = kLmThreads / 32;
constexpr int kCamThreads = 256;  // threads per camera (camera pass)
constexpr int kCamWarps = kCamThreads / 32;
constexpr int kSym = 21;          // independent entries of the symmetric Hpp
constexpr int kCamVals = kSym + 6;  // + bp
constexpr int kUFloats = 18;      // U per slot (6 x 3)
constexpr int kLmChunk = 16;      // most slots per landmark in a landmark-pass chunk
constexpr int kChi2Chunk = 64;    // most slots per landmark in a K3 chunk
constexpr float kZeps = 1e-6f;

struct Cam {
  float fx, fy, cx, cy, bf;
  int robust;
  float delta;
};

struct Pose {
  float R[9];
  float t[3];
};

struct Slot {
  float r[3];
  float w;         // IRLS weight: w_active times the Huber factor
  float rho;       // robust cost of the slot
  float Jp[3][6];  // d r / d pose (left-perturbation), times the free flag
  float Jl[3][3];  // d r / d point
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ R,
                                          const float* __restrict__ t, int c) {
  Pose p;
#pragma unroll
  for (int j = 0; j < 9; ++j) p.R[j] = __ldg(R + c * 9 + j);
#pragma unroll
  for (int j = 0; j < 3; ++j) p.t[j] = __ldg(t + c * 3 + j);
  return p;
}

// One slot: projection, residual, Huber weight and cost, and (kJac) the
// Jacobians. The residual, weight and cost are the same bits in every pass.
template <bool kJac>
__device__ __forceinline__ void slot_terms(const Pose& ps, float fr, float X0, float X1,
                                           float X2, float uo, float vo, float ro,
                                           float w_info, const Cam& c, Slot& s) {
  const float* R = ps.R;
  const float xc0 = __fadd_rn(__fmaf_rn(R[2], X2, __fmaf_rn(R[1], X1, __fmul_rn(R[0], X0))),
                              ps.t[0]);
  const float xc1 = __fadd_rn(__fmaf_rn(R[5], X2, __fmaf_rn(R[4], X1, __fmul_rn(R[3], X0))),
                              ps.t[1]);
  const float xc2 = __fadd_rn(__fmaf_rn(R[8], X2, __fmaf_rn(R[7], X1, __fmul_rn(R[6], X0))),
                              ps.t[2]);
  const float z = fmaxf(xc2, kZeps);
  const float iz = __fdiv_rn(1.f, z);
  const float u = __fadd_rn(__fmul_rn(__fmul_rn(c.fx, xc0), iz), c.cx);
  const float v = __fadd_rn(__fmul_rn(__fmul_rn(c.fy, xc1), iz), c.cy);
  const float ur = __fsub_rn(u, __fmul_rn(c.bf, iz));
  const float st = ro >= 0.f ? 1.f : 0.f;
  s.r[0] = __fsub_rn(u, uo);
  s.r[1] = __fsub_rn(v, vo);
  s.r[2] = __fmul_rn(__fsub_rn(ur, ro), st);
  const float e2 = __fmul_rn(
      w_info, __fmaf_rn(s.r[2], s.r[2], __fmaf_rn(s.r[1], s.r[1], __fmul_rn(s.r[0], s.r[0]))));
  s.w = w_info;
  s.rho = e2;
  if (c.robust) {
    const float sqrt_e2 = __fsqrt_rn(fmaxf(e2, 1e-12f));
    const float d2 = __fmul_rn(c.delta, c.delta);
    const bool inl = e2 <= d2;
    s.rho = inl ? e2 : __fsub_rn(__fmul_rn(__fmul_rn(2.f, c.delta), sqrt_e2), d2);
    s.w = inl ? w_info : __fmul_rn(w_info, __fdiv_rn(c.delta, sqrt_e2));
  }
  if constexpr (kJac) {
    const float iz2 = iz * iz;
    // d(u, v, u_r)/d x_c; the stereo row is masked by st.
    const float d[3][3] = {{c.fx * iz, 0.f, -c.fx * xc0 * iz2},
                           {0.f, c.fy * iz, -c.fy * xc1 * iz2},
                           {c.fx * iz * st, 0.f, (-c.fx * xc0 * iz2 + c.bf * iz2) * st}};
    // Jp = d @ [I | -hat(x_c)] (unclamped x_c in the hat), Jl = d @ R.
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s.Jp[a][0] = d[a][0] * fr;
      s.Jp[a][1] = d[a][1] * fr;
      s.Jp[a][2] = d[a][2] * fr;
      s.Jp[a][3] = (-d[a][1] * xc2 + d[a][2] * xc1) * fr;
      s.Jp[a][4] = (d[a][0] * xc2 - d[a][2] * xc0) * fr;
      s.Jp[a][5] = (-d[a][0] * xc1 + d[a][1] * xc0) * fr;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        s.Jl[a][j] = d[a][0] * R[j] + d[a][1] * R[3 + j] + d[a][2] * R[6 + j];
    }
  }
}

// Camera ids are clamped into [0, P), as XLA's gather clamps.
__device__ __forceinline__ int clamp_cam(int c, int P) { return c < 0 ? 0 : (c >= P ? P - 1 : c); }

// The chi2 tile sum of K2 and K3: thread t's value v is landmark t of the
// tile (threads >= 128 give nothing). A fixed-shape shuffle tree per warp
// (lane i adds lane i + 16, then i + 8, ...), then the 4 warp sums in warp
// order. Every thread of the block calls it (blockDim.x >= 128) and gets the
// sum; it holds two block barriers.
__device__ __forceinline__ float tile_sum(float v, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && warp < kLmWarps) s_warp[warp] = v;
  __syncthreads();
  float s = s_warp[0];
#pragma unroll
  for (int w = 1; w < kLmWarps; ++w) s = __fadd_rn(s, s_warp[w]);
  __syncthreads();  // s_warp is free for the next call
  return s;
}

// The chi2 total over `n` tile partials: lane t (< 128) adds the partials
// t, t + 128, t + 256, ... in index order, then `tile_sum`. Read through L2
// (the partials may come from other blocks of the same launch).
__device__ __forceinline__ float total_sum(const float* partial, int n, float* s_warp) {
  float v = 0.f;
  if (threadIdx.x < kLmThreads)
    for (int i = threadIdx.x; i < n; i += kLmThreads) v = __fadd_rn(v, __ldcg(partial + i));
  return tile_sum(v, s_warp);
}

// Position of U float f of the block in the padded staging buffer.
__device__ __forceinline__ int u_pos(int f) { return f + (f >> 5); }

// Slots per landmark in a chunk: the fewest chunks of at most `most` slots,
// as equal as they can be.
int chunk_slots(int K, int most) {
  const int n = (K + most - 1) / most;
  return (K + n - 1) / n;
}

size_t landmark_smem_bytes(int C) {
  const size_t n = (size_t)kLmThreads * C * kUFloats;
  return sizeof(float) * (n + n / 32 + 1);
}

// Copy n floats from shared `src` (16-byte aligned) to global `dst`
// (16-byte aligned), 16 bytes per store.
__device__ __forceinline__ void store_span(float* __restrict__ dst, const float* src, int n) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int q = threadIdx.x; q < n / 4; q += kLmThreads) d4[q] = s4[q];
  for (int f = (n / 4) * 4 + threadIdx.x; f < n; f += kLmThreads) dst[f] = src[f];
}

// Slots [k0, k0 + ck) of landmark l (thread tid of its block): Hll, bl and
// chi2 summed into the thread's registers, each slot's U row staged at
// (tid * ck + k - k0) * 18 in the padded buffer.
__device__ __forceinline__ void landmark_slots(
    const float* __restrict__ pose_R, const float* __restrict__ pose_t,
    const float* __restrict__ pose_free, const int32_t* __restrict__ obs_cam,
    const float* __restrict__ obs_uvr, const float* __restrict__ w_active, int P, int K,
    const Cam& cam, int l, int tid, int k0, int ck, float X0, float X1, float X2,
    float (&hll)[9], float (&blv)[3], float& chi, float* s_u) {
  for (int k = k0; k < k0 + ck; ++k) {
    const size_t e = (size_t)l * K + k;
    const int c = clamp_cam(obs_cam[e], P);
    const Pose ps = load_pose(pose_R, pose_t, c);
    Slot s;
    slot_terms<true>(ps, __ldg(pose_free + c), X0, X1, X2, obs_uvr[e * 3 + 0],
                     obs_uvr[e * 3 + 1], obs_uvr[e * 3 + 2], w_active[e], cam, s);
    chi = __fadd_rn(chi, s.rho);
    const float w = s.w;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      blv[i] += s.Jl[0][i] * w * s.r[0] + s.Jl[1][i] * w * s.r[1] + s.Jl[2][i] * w * s.r[2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        hll[3 * i + j] += s.Jl[0][i] * w * s.Jl[0][j] + s.Jl[1][i] * w * s.Jl[1][j] +
                          s.Jl[2][i] * w * s.Jl[2][j];
    }
    const int f0 = (tid * ck + k - k0) * kUFloats;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        s_u[u_pos(f0 + 3 * i + j)] = s.Jp[0][i] * w * s.Jl[0][j] +
                                     s.Jp[1][i] * w * s.Jl[1][j] +
                                     s.Jp[2][i] * w * s.Jl[2][j];
    }
  }
}

// kChunked = false is the one-chunk instance (C = K, up to K = 16): its U
// rows are one contiguous span of the block.
template <bool kChunked>
__global__ void __launch_bounds__(kLmThreads)
ba_landmark_kernel(const float* __restrict__ pose_R, const float* __restrict__ pose_t,
                   const float* __restrict__ pose_free, const float* __restrict__ points,
                   const int32_t* __restrict__ obs_cam, const float* __restrict__ obs_uvr,
                   const float* __restrict__ w_active, int P, int L, int K, int C, Cam cam,
                   float* __restrict__ Hll, float* __restrict__ bl, float* __restrict__ U,
                   float* __restrict__ chi_partial) {
  extern __shared__ float4 smem4[];
  float* s_u = reinterpret_cast<float*>(smem4);
  __shared__ float s_warp[kLmWarps];

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kLmThreads;
  const int nl = min(kLmThreads, L - l0);
  const int l = l0 + tid;
  const bool live = tid < nl;
  float X0 = 0.f, X1 = 0.f, X2 = 0.f;
  if (live) {
    X0 = points[l * 3 + 0];
    X1 = points[l * 3 + 1];
    X2 = points[l * 3 + 2];
  }
  float hll[9];
  float blv[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 9; ++i) hll[i] = 0.f;
  float chi = 0.f;

  if constexpr (kChunked) {
    for (int k0 = 0; k0 < K; k0 += C) {
      const int ck = min(C, K - k0);  // slots of this chunk
      if (live)
        landmark_slots(pose_R, pose_t, pose_free, obs_cam, obs_uvr, w_active, P, K, cam, l,
                       tid, k0, ck, X0, X1, X2, hll, blv, chi, s_u);
      __syncthreads();  // the chunk is staged
      // Landmark i's chunk is the span of ck * 18 floats at (l0 + i) * K + k0
      // slots into U: 8-byte aligned (a slot is 72 bytes), and a pair of
      // floats at an even position shares one padding offset.
      const int span = ck * kUFloats;
      for (int q = tid; q < nl * span / 2; q += kLmThreads) {
        const int f = 2 * q;
        const int i = f / span;
        const int b = u_pos(f);
        *reinterpret_cast<float2*>(U + ((size_t)(l0 + i) * K + k0) * kUFloats + (f - i * span)) =
            make_float2(s_u[b], s_u[b + 1]);
      }
      __syncthreads();  // s_u is free for the next chunk
    }
  } else if (live) {
    landmark_slots(pose_R, pose_t, pose_free, obs_cam, obs_uvr, w_active, P, K, cam, l, tid, 0,
                   K, X0, X1, X2, hll, blv, chi, s_u);
  }
  // The block is chi2 tile blockIdx.x; with one chunk the sum's barrier also
  // orders the U staging before the stores.
  const float tile_chi = tile_sum(chi, s_warp);
  if (tid == 0) chi_partial[blockIdx.x] = tile_chi;

  if constexpr (!kChunked) {
    // The block's U rows are one contiguous span of U, 16-byte aligned
    // (l0 * K * 72 bytes with l0 a multiple of 128).
    const int n = nl * K * kUFloats;
    float* Ub = U + (size_t)l0 * K * kUFloats;
    float4* U4 = reinterpret_cast<float4*>(Ub);
    for (int q = tid; q < n / 4; q += kLmThreads) {
      const int b = u_pos(4 * q);  // the 4 floats share one padding offset
      U4[q] = make_float4(s_u[b], s_u[b + 1], s_u[b + 2], s_u[b + 3]);
    }
    for (int f = (n / 4) * 4 + tid; f < n; f += kLmThreads) Ub[f] = s_u[u_pos(f)];
    __syncthreads();
  }

  // Hll and bl through the same buffer (their spans start at l0 * 36 and
  // l0 * 12 bytes: 16-byte aligned too).
  float* s_h = s_u;
  float* s_b = s_u + kLmThreads * 9;
  if (live) {
#pragma unroll
    for (int i = 0; i < 9; ++i) s_h[tid * 9 + i] = hll[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) s_b[tid * 3 + i] = blv[i];
  }
  __syncthreads();
  store_span(Hll + (size_t)l0 * 9, s_h, nl * 9);
  store_span(bl + (size_t)l0 * 3, s_b, nl * 3);
}

// Index of Hpp entry (a, b), a <= b, in the packed upper triangle.
__host__ __device__ constexpr int sym_index(int a, int b) { return a * (11 - a) / 2 + b; }

__global__ void __launch_bounds__(kCamThreads)
ba_camera_kernel(const float* __restrict__ pose_R, const float* __restrict__ pose_t,
                 const float* __restrict__ pose_free, const float* __restrict__ points,
                 const float* __restrict__ obs_uvr, const float* __restrict__ w_active,
                 const int32_t* __restrict__ cam_offsets,
                 const int32_t* __restrict__ cam_members, int P, int K, Cam cam,
                 const float* __restrict__ chi_partial, int n_chi, float* __restrict__ Hpp,
                 float* __restrict__ bp, float* __restrict__ chi2) {
  __shared__ float s_red[kCamWarps][kCamVals];
  __shared__ float s_warp[kLmWarps];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  if (p == P) {  // the extra block: the chi2 total over the landmark pass's tiles
    const float total = total_sum(chi_partial, n_chi, s_warp);
    if (tid == 0) chi2[0] = total;
    return;
  }
  float acc[kCamVals];
#pragma unroll
  for (int v = 0; v < kCamVals; ++v) acc[v] = 0.f;
  const float fr = pose_free[p];
  if (fr != 0.f) {  // a fixed camera's Jp is zero: its rows stay exact zeros
    const Pose ps = load_pose(pose_R, pose_t, p);
    const int end = cam_offsets[p + 1];
    for (int j = cam_offsets[p] + tid; j < end; j += kCamThreads) {
      const int e = cam_members[j];
      const int l = e / K;
      Slot s;
      slot_terms<true>(ps, fr, points[l * 3 + 0], points[l * 3 + 1], points[l * 3 + 2],
                       obs_uvr[(size_t)e * 3 + 0], obs_uvr[(size_t)e * 3 + 1],
                       obs_uvr[(size_t)e * 3 + 2], w_active[e], cam, s);
      float wJ[3][6];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int i = 0; i < 6; ++i) wJ[a][i] = s.w * s.Jp[a][i];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j)
          acc[sym_index(i, j)] += wJ[0][i] * s.Jp[0][j] + wJ[1][i] * s.Jp[1][j] +
                                  wJ[2][i] * s.Jp[2][j];
        acc[kSym + i] += wJ[0][i] * s.r[0] + wJ[1][i] * s.r[1] + wJ[2][i] * s.r[2];
      }
    }
  }
  // Fixed-shape tree within each warp, then the warps in warp order.
#pragma unroll
  for (int v = 0; v < kCamVals; ++v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[v] += __shfl_down_sync(0xffffffffu, acc[v], off);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < kCamVals; ++v) s_red[warp][v] = acc[v];
  }
  __syncthreads();
  if (tid < 42) {
    int v;
    if (tid < 36) {
      const int a = tid / 6, b = tid % 6;
      v = a <= b ? sym_index(a, b) : sym_index(b, a);
    } else {
      v = kSym + (tid - 36);
    }
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kCamWarps; ++w) sum += s_red[w][v];
    if (tid < 36) Hpp[p * 36 + tid] = sum;
    else bp[p * 6 + (tid - 36)] = sum;
  }
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

// K3: block t is chi2 tile t. Its threads evaluate the tile's slots in
// chunks of C slots per landmark (C = K up to K = 64) and, within a chunk, in
// flat order (slot f by thread f mod blockDim.x, so neighbouring lanes read
// neighbouring slots of a landmark and the observation loads coalesce; poses
// through the read-only cache and L2), each slot's rho into shared memory.
// Thread i then adds landmark i's C values in slot order to its running sum,
// the sum K2's thread makes, and after the last chunk `tile_sum` gives the
// tile partial. The block that finishes last (an integer ticket after a
// fence) sums the partials by tile index and resets the ticket for the next
// launch on its stream. kChunked = false is the one-chunk instance (C = K),
// whose slot f of the tile is simply slot e0 + f of the problem.
template <bool kChunked>
__global__ void __launch_bounds__(1024)
ba_chi2_kernel(const float* __restrict__ pose_R, const float* __restrict__ pose_t,
               const float* __restrict__ points, const int32_t* __restrict__ obs_cam,
               const float* __restrict__ obs_uvr, const float* __restrict__ w_active, int P,
               int L, int K, int C, Cam cam, float* __restrict__ partial,
               unsigned int* __restrict__ ticket, float* __restrict__ chi2) {
  extern __shared__ float s_rho[];  // kLmThreads * C
  __shared__ float s_warp[kLmWarps];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int l0 = t * kLmThreads;
  const int nl = min(kLmThreads, L - l0);
  const size_t e0 = (size_t)l0 * K;
  float chi = 0.f;
  for (int k0 = 0; k0 < K; k0 += C) {
    const int ck = kChunked ? min(C, K - k0) : K;
#pragma unroll 4
    for (int f = tid; f < nl * ck; f += blockDim.x) {
      size_t l, e;
      if constexpr (kChunked) {
        const int i = f / ck;
        l = (size_t)l0 + i;
        e = l * K + k0 + (f - i * ck);
      } else {
        l = (size_t)l0 + f / K;
        e = e0 + f;
      }
      const Pose ps = load_pose(pose_R, pose_t, clamp_cam(__ldg(obs_cam + e), P));
      Slot s;
      slot_terms<false>(ps, 1.f, __ldg(points + l * 3 + 0), __ldg(points + l * 3 + 1),
                        __ldg(points + l * 3 + 2), __ldg(obs_uvr + e * 3 + 0),
                        __ldg(obs_uvr + e * 3 + 1), __ldg(obs_uvr + e * 3 + 2),
                        __ldg(w_active + e), cam, s);
      s_rho[f] = s.rho;
    }
    __syncthreads();
    if (tid < nl)
      for (int k = 0; k < ck; ++k) chi = __fadd_rn(chi, s_rho[tid * ck + k]);
    if constexpr (kChunked) __syncthreads();  // s_rho is free for the next chunk
  }
  const float tile_chi = tile_sum(chi, s_warp);

  if (tid == 0) {
    partial[t] = tile_chi;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    const float total = total_sum(partial, (L + kLmThreads - 1) / kLmThreads, s_warp);
    if (tid == 0) {
      chi2[0] = total;
      *ticket = 0u;
    }
  }
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device when a launch needs more than was allowed so far. `allowed` is the
// kernel's own cache, one entry per device.
constexpr int kMaxDevices = 64;
int set_smem(const void* kernel, size_t bytes, size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && bytes <= allowed[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) allowed[dev] = bytes;
  return 0;
}
size_t g_landmark_smem[kMaxDevices];  // per instance of the landmark kernel
size_t g_landmark_smem_chunked[kMaxDevices];
int g_sms[kMaxDevices];  // SMs per device, 0 until read

}  // namespace

// Landmarks per chi2 tile (a landmark-pass block): the wrappers size the
// tile-partial scratch as ceil(L / threads) floats.
extern "C" int ba_assembly_threads() { return kLmThreads; }

// K2: the landmark pass, then the camera pass (with the chi2 total), on
// `stream`. cam_offsets (P + 1) and cam_members list each camera's slots
// (flat indices l * K + k). Returns cudaGetLastError() (0 = launched).
extern "C" int ba_assembly_launch(
    const void* pose_R, const void* pose_t, const void* pose_free, const void* points,
    const void* obs_cam, const void* obs_uvr, const void* w_active, const void* cam_offsets,
    const void* cam_members, int P, int L, int K, float fx, float fy, float cx, float cy,
    float bf, int robust, float delta, void* Hll, void* bl, void* U, void* chi_partial,
    void* Hpp, void* bp, void* chi2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cam cam{fx, fy, cx, cy, bf, robust, delta};
  const int n_blocks = (L + kLmThreads - 1) / kLmThreads;
  if (n_blocks > 0) {
    const int C = chunk_slots(K, kLmChunk);
    const size_t smem = landmark_smem_bytes(C);
    auto kernel = C == K ? &ba_landmark_kernel<false> : &ba_landmark_kernel<true>;
    int err = set_smem(reinterpret_cast<const void*>(kernel), smem,
                       C == K ? g_landmark_smem : g_landmark_smem_chunked);
    if (err != 0) return err;
    kernel<<<n_blocks, kLmThreads, smem, s>>>(
        static_cast<const float*>(pose_R), static_cast<const float*>(pose_t),
        static_cast<const float*>(pose_free), static_cast<const float*>(points),
        static_cast<const int32_t*>(obs_cam), static_cast<const float*>(obs_uvr),
        static_cast<const float*>(w_active), P, L, K, C, cam, static_cast<float*>(Hll),
        static_cast<float*>(bl), static_cast<float*>(U), static_cast<float*>(chi_partial));
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  ba_camera_kernel<<<P + 1, kCamThreads, 0, s>>>(
      static_cast<const float*>(pose_R), static_cast<const float*>(pose_t),
      static_cast<const float*>(pose_free), static_cast<const float*>(points),
      static_cast<const float*>(obs_uvr), static_cast<const float*>(w_active),
      static_cast<const int32_t*>(cam_offsets), static_cast<const int32_t*>(cam_members), P,
      K, cam, static_cast<const float*>(chi_partial), n_blocks, static_cast<float*>(Hpp),
      static_cast<float*>(bp), static_cast<float*>(chi2));
  return static_cast<int>(cudaGetLastError());
}

// K3: one launch on `stream`, one block per tile of 128 landmarks.
// chi_partial holds max(ceil(L / 128), 1) floats; ticket is this stream's
// counter, 0 between launches (the last block resets it). 256 threads per
// tile; one thread per slot of a chunk (at most 1,024) when the tiles are
// fewer than the SMs, where latency and not throughput sets the time. The
// block size does not enter the float order. Returns cudaGetLastError() (0 = launched).
extern "C" int ba_chi2_launch(
    const void* pose_R, const void* pose_t, const void* points, const void* obs_cam,
    const void* obs_uvr, const void* w_active, int P, int L, int K, float fx, float fy,
    float cx, float cy, float bf, int robust, float delta, void* chi_partial, void* ticket,
    void* chi2, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = dev < kMaxDevices ? g_sms[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) g_sms[dev] = sms;
  }
  const int n_tiles = (L + kLmThreads - 1) / kLmThreads;
  const int C = chunk_slots(K, kChi2Chunk);
  int threads = 2 * kLmThreads;
  if (n_tiles < sms) threads = C * kLmThreads > 1024 ? 1024 : C * kLmThreads;
  const Cam cam{fx, fy, cx, cy, bf, robust, delta};
  const size_t smem = sizeof(float) * kLmThreads * C;  // <= 32 KB: no opt-in needed
  auto kernel = C == K ? &ba_chi2_kernel<false> : &ba_chi2_kernel<true>;
  kernel<<<n_tiles > 0 ? n_tiles : 1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose_R), static_cast<const float*>(pose_t),
      static_cast<const float*>(points), static_cast<const int32_t*>(obs_cam),
      static_cast<const float*>(obs_uvr), static_cast<const float*>(w_active), P, L, K, C, cam,
      static_cast<float*>(chi_partial), static_cast<unsigned int*>(ticket),
      static_cast<float*>(chi2));
  return static_cast<int>(cudaGetLastError());
}
