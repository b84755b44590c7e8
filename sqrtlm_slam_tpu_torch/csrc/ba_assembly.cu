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
// Design: two passes on one stream, neither with atomics, so every sum has a
// fixed order and runs are bit-for-bit repeatable (an LM accept test at gain
// ratio ~0 flips on float32 reassociation).
//  1. Landmark pass (landmark-major): one thread per landmark loops over its
//     K slots, reading poses through the read-only cache (they stay in L2),
//     keeping Hll, bl and its chi2 in registers. The block stages its U rows
//     in shared memory (one padding float every 32, so the per-slot writes
//     spread over the banks) and writes its contiguous U span, then Hll and
//     bl, with 16-byte stores. Its shared memory depends on K only, not on P.
//     The block's chi2 is summed in thread order into one float per block.
//  2. Camera pass (camera-major): one block per camera walks that camera's
//     slots from the compressed slot table of optim/segment.py (members in
//     their order in the data), recomputes each slot's Jp, r and w, and
//     accumulates the 21 + 6 independent Hpp/bp entries in registers with a
//     fixed stride of 256 slots per thread; then a fixed-shape warp-shuffle
//     tree and a sum over the 8 warps in warp order. A fixed camera's rows
//     are zeros. Slots not in the table are inactive (w = 0) and would add
//     exact zeros. One extra block sums the landmark blocks' chi2 in block
//     order. No pose cap: nothing here scales with P but the grid.
//
// K3 (chi2 only) replaces the TPU kernel assembly_pallas.py::chi2_prepared
// (body `_chi2_kernel`), the residual-only robust chi2 of the LM candidate
// test. It keeps its one-thread-per-landmark loop with the poses staged in
// shared memory (13 floats each, so at most ~4,460 poses fit) and the same
// summation order as K2's landmark pass (per thread over its K slots, per
// 128-thread block in thread order, then the blocks in block order). Every
// pass computes a slot through one function, `slot_terms`, whose residual,
// weight and loss use explicitly rounded operations (no FMA contraction that
// could differ between instantiations), so K3's chi2 is bitwise equal to
// K2's and a slot's w is the same in both K2 passes. Bound: ~20 bytes read
// per slot; 4 bytes written per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLmThreads = 128;   // landmarks per block (landmark pass and K3)
constexpr int kCamThreads = 256;  // threads per camera (camera pass)
constexpr int kCamWarps = kCamThreads / 32;
constexpr int kSym = 21;          // independent entries of the symmetric Hpp
constexpr int kCamVals = kSym + 6;  // + bp
constexpr int kUFloats = 18;      // U per slot (6 x 3)
constexpr int kPose = 13;         // K3's staged pose: R (9, row-major), t (3), pad
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

// Serial sum in index order: the per-block chi2 (over threads) and the
// total (over blocks) of both K2 and K3.
__device__ __forceinline__ float sum_in_order(const float* x, int n) {
  float s = 0.f;
#pragma unroll 16
  for (int i = 0; i < n; ++i) s = __fadd_rn(s, x[i]);  // loads batched, adds in order
  return s;
}

// Position of U float f of the block in the padded staging buffer.
__device__ __forceinline__ int u_pos(int f) { return f + (f >> 5); }

size_t landmark_smem_bytes(int K) {
  const size_t n = (size_t)kLmThreads * K * kUFloats;
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

__global__ void __launch_bounds__(kLmThreads)
ba_landmark_kernel(const float* __restrict__ pose_R, const float* __restrict__ pose_t,
                   const float* __restrict__ pose_free, const float* __restrict__ points,
                   const int32_t* __restrict__ obs_cam, const float* __restrict__ obs_uvr,
                   const float* __restrict__ w_active, int P, int L, int K, Cam cam,
                   float* __restrict__ Hll, float* __restrict__ bl, float* __restrict__ U,
                   float* __restrict__ chi_partial) {
  extern __shared__ float4 smem4[];
  float* s_u = reinterpret_cast<float*>(smem4);
  __shared__ float s_chi[kLmThreads];

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

  if (live) {
    for (int k = 0; k < K; ++k) {
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
      const int f0 = (tid * K + k) * kUFloats;
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
  s_chi[tid] = chi;
  __syncthreads();

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
  if (tid == 0) chi_partial[blockIdx.x] = sum_in_order(s_chi, kLmThreads);
  __syncthreads();

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
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  if (p == P) {  // the extra block: total chi2 over the landmark blocks, in order
    if (tid == 0) chi2[0] = sum_in_order(chi_partial, n_chi);
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

__global__ void __launch_bounds__(kLmThreads)
ba_chi2_kernel(const float* __restrict__ pose_R, const float* __restrict__ pose_t,
               const float* __restrict__ points, const int32_t* __restrict__ obs_cam,
               const float* __restrict__ obs_uvr, const float* __restrict__ w_active, int P,
               int L, int K, Cam cam, float* __restrict__ chi_partial) {
  extern __shared__ float s_pose[];  // P * kPose
  __shared__ float s_chi[kLmThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < P; i += kLmThreads) {
#pragma unroll
    for (int j = 0; j < 9; ++j) s_pose[i * kPose + j] = pose_R[i * 9 + j];
#pragma unroll
    for (int j = 0; j < 3; ++j) s_pose[i * kPose + 9 + j] = pose_t[i * 3 + j];
  }
  __syncthreads();

  const int l = blockIdx.x * kLmThreads + tid;
  float chi = 0.f;
  if (l < L) {
    const float X0 = points[l * 3 + 0], X1 = points[l * 3 + 1], X2 = points[l * 3 + 2];
    for (int k = 0; k < K; ++k) {
      const size_t e = (size_t)l * K + k;
      const float* sp = s_pose + clamp_cam(obs_cam[e], P) * kPose;
      Pose ps;
#pragma unroll
      for (int j = 0; j < 9; ++j) ps.R[j] = sp[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) ps.t[j] = sp[9 + j];
      Slot s;
      slot_terms<false>(ps, 1.f, X0, X1, X2, obs_uvr[e * 3 + 0], obs_uvr[e * 3 + 1],
                        obs_uvr[e * 3 + 2], w_active[e], cam, s);
      chi = __fadd_rn(chi, s.rho);
    }
  }
  s_chi[tid] = chi;
  __syncthreads();
  if (tid == 0) chi_partial[blockIdx.x] = sum_in_order(s_chi, kLmThreads);
}

__global__ void chi2_total_kernel(const float* __restrict__ chi_partial, int n,
                                  float* __restrict__ chi2) {
  if (threadIdx.x == 0) chi2[0] = sum_in_order(chi_partial, n);
}

// K3's dynamic shared memory (the staged poses); its s_chi is static.
size_t chi2_smem_bytes(int P) { return sizeof(float) * (size_t)P * kPose; }

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
size_t g_landmark_smem[kMaxDevices];
size_t g_chi2_smem[kMaxDevices];

}  // namespace

// K3's shared memory for P poses, static part included; the wrapper checks
// it against the device limit before launching.
extern "C" size_t ba_chi2_smem_bytes(int P) {
  return chi2_smem_bytes(P) + sizeof(float) * kLmThreads;
}

// Opt-in shared-memory limit of one block on `device` (bytes; -1 on error).
extern "C" int ba_assembly_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

// Landmarks per block of the landmark pass and of K3: the wrapper sizes the
// per-block chi2 scratch as ceil(L / threads) floats.
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
    const size_t smem = landmark_smem_bytes(K);
    int err = set_smem(reinterpret_cast<const void*>(ba_landmark_kernel), smem, g_landmark_smem);
    if (err != 0) return err;
    ba_landmark_kernel<<<n_blocks, kLmThreads, smem, s>>>(
        static_cast<const float*>(pose_R), static_cast<const float*>(pose_t),
        static_cast<const float*>(pose_free), static_cast<const float*>(points),
        static_cast<const int32_t*>(obs_cam), static_cast<const float*>(obs_uvr),
        static_cast<const float*>(w_active), P, L, K, cam, static_cast<float*>(Hll),
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

// K3: the per-block chi2 pass, then the total, on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int ba_chi2_launch(
    const void* pose_R, const void* pose_t, const void* points, const void* obs_cam,
    const void* obs_uvr, const void* w_active, int P, int L, int K, float fx, float fy,
    float cx, float cy, float bf, int robust, float delta, void* chi_partial, void* chi2,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cam cam{fx, fy, cx, cy, bf, robust, delta};
  const int n_blocks = (L + kLmThreads - 1) / kLmThreads;
  if (n_blocks > 0) {
    const size_t smem = chi2_smem_bytes(P);
    int err = set_smem(reinterpret_cast<const void*>(ba_chi2_kernel), smem, g_chi2_smem);
    if (err != 0) return err;
    ba_chi2_kernel<<<n_blocks, kLmThreads, smem, s>>>(
        static_cast<const float*>(pose_R), static_cast<const float*>(pose_t),
        static_cast<const float*>(points), static_cast<const int32_t*>(obs_cam),
        static_cast<const float*>(obs_uvr), static_cast<const float*>(w_active), P, L, K, cam,
        static_cast<float*>(chi_partial));
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  chi2_total_kernel<<<1, 32, 0, s>>>(static_cast<const float*>(chi_partial), n_blocks,
                                     static_cast<float*>(chi2));
  return static_cast<int>(cudaGetLastError());
}
