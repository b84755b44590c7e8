// K2: bucketed bundle-adjustment assembly (residuals, Jacobians, Huber IRLS
// weights and every reduction the sqrt-Schur step needs) in one pass.
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
// What bounds it on Hopper: per slot ~400 FLOP against ~50 bytes of input
// and 72 bytes of U output, so the landmark-local part is memory/latency
// bound and small (L*K*~130 B = 5 MB at L=8192, K=5). The hard part is the
// camera-keyed reduction: the TPU kernel carried Hpp/bp in one VMEM
// accumulator across its *sequential* grid; Hopper blocks run in parallel
// and in no order.
//
// K3 (chi2 only) is the same kernel compiled with kChi2Only = true: it
// replaces the TPU kernel assembly_pallas.py::chi2_prepared (body
// `_chi2_kernel`), the residual-only robust chi2 of the LM candidate test.
// It keeps the projection, the kZeps depth clamp, the stereo-row mask, the
// Huber rho and the summation order (per thread over its K slots, per block
// in thread order, then the blocks in block order), and skips the
// Jacobians, U, Hll, bl and the camera-keyed partials. So K3 is bitwise
// repeatable and, on the same inputs, bitwise equal to K2's chi2. Bound:
// ~50 bytes read and ~60 FLOP per slot; 4 bytes written per block.
//
// Design: one thread per landmark loops over its K slots, keeping Hll/bl in
// registers and writing U per slot. The block's poses are staged in shared
// memory (13 floats per camera). For the camera sums each block owns a
// shared (P, 42) partial [Hpp row-major 36 | bp 6]: per slot, every thread
// stages its 42 values and camera in shared memory, then 42 threads (one per
// entry) add the 128 staged rows in thread order. The block writes its
// partial (and its chi2 sum, also in thread order) to a scratch row, and a
// second kernel sums the rows in block order. Every sum therefore has a
// fixed order: runs are bit-for-bit repeatable (an LM accept test at gain
// ratio ~0 flips on f32 reassociation, so repeatability matters more than
// the few microseconds global atomics would save). L needs no padding; the
// ragged last block contributes zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // landmarks per block
constexpr int kEntries = 42;   // 36 Hpp + 6 bp per camera
constexpr int kPose = 13;      // R (9, row-major), t (3), free flag (1)
constexpr float kZeps = 1e-6f;

template <bool kChi2Only>
__global__ void __launch_bounds__(kThreads)
ba_assembly_kernel(const float* __restrict__ pose_R, const float* __restrict__ pose_t,
                   const float* __restrict__ pose_free, const float* __restrict__ points,
                   const int32_t* __restrict__ obs_cam, const float* __restrict__ obs_uvr,
                   const float* __restrict__ w_active, int P, int L, int K,
                   float fx, float fy, float cx, float cy, float bf,
                   int robust, float delta,
                   float* __restrict__ Hll, float* __restrict__ bl,
                   float* __restrict__ U, float* __restrict__ partial) {
  // K3 keeps only the poses and the per-thread chi2 in shared memory.
  constexpr int kSlot = kChi2Only ? 0 : kEntries;
  const int n_acc = kChi2Only ? 0 : P * kEntries;
  extern __shared__ float smem[];
  float* s_pose = smem;                          // P * kPose
  float* s_acc = s_pose + P * kPose;             // n_acc
  float* s_slot = s_acc + n_acc;                 // kThreads * kSlot
  float* s_chi = s_slot + kThreads * kSlot;      // kThreads
  int* s_cam = reinterpret_cast<int*>(s_chi + kThreads);  // kThreads (K2)

  const int tid = threadIdx.x;
  for (int i = tid; i < P; i += kThreads) {
#pragma unroll
    for (int j = 0; j < 9; ++j) s_pose[i * kPose + j] = pose_R[i * 9 + j];
#pragma unroll
    for (int j = 0; j < 3; ++j) s_pose[i * kPose + 9 + j] = pose_t[i * 3 + j];
    if constexpr (!kChi2Only) s_pose[i * kPose + 12] = pose_free[i];
  }
  for (int i = tid; i < n_acc; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();

  const int l = blockIdx.x * kThreads + tid;
  const bool live = l < L;
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

  for (int k = 0; k < K; ++k) {
    float vals[kSlot > 0 ? kSlot : 1];
#pragma unroll
    for (int i = 0; i < kSlot; ++i) vals[i] = 0.f;
    int cam = 0;
    if (live) {
      const size_t e = (size_t)l * K + k;
      cam = obs_cam[e];
      cam = cam < 0 ? 0 : (cam >= P ? P - 1 : cam);  // gather clamps, as XLA does
      const float* ps = s_pose + cam * kPose;
      const float w_info = w_active[e];
      const float uo = obs_uvr[e * 3 + 0];
      const float vo = obs_uvr[e * 3 + 1];
      const float ro = obs_uvr[e * 3 + 2];
      const float st = ro >= 0.f ? 1.f : 0.f;

      const float xc0 = ps[0] * X0 + ps[1] * X1 + ps[2] * X2 + ps[9];
      const float xc1 = ps[3] * X0 + ps[4] * X1 + ps[5] * X2 + ps[10];
      const float xc2 = ps[6] * X0 + ps[7] * X1 + ps[8] * X2 + ps[11];
      const float z = fmaxf(xc2, kZeps);
      const float iz = 1.f / z;
      const float iz2 = iz * iz;
      const float u = fx * xc0 * iz + cx;
      const float v = fy * xc1 * iz + cy;
      const float ur = u - bf * iz;
      const float r[3] = {u - uo, v - vo, (ur - ro) * st};

      const float e2 = w_info * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
      float w = w_info, rho = e2;
      if (robust) {
        const float sqrt_e2 = sqrtf(fmaxf(e2, 1e-12f));
        const bool inl = e2 <= delta * delta;
        rho = inl ? e2 : 2.f * delta * sqrt_e2 - delta * delta;
        w = w_info * (inl ? 1.f : delta / sqrt_e2);
      }
      chi += rho;

      if constexpr (!kChi2Only) {
        // d(u, v, u_r)/d x_c; the stereo row is masked by st.
        const float d[3][3] = {
            {fx * iz, 0.f, -fx * xc0 * iz2},
            {0.f, fy * iz, -fy * xc1 * iz2},
            {fx * iz * st, 0.f, (-fx * xc0 * iz2 + bf * iz2) * st}};
        // Jp = d @ [I | -hat(x_c)] (unclamped x_c in the hat), Jl = d @ R.
        float Jp[3][6], Jl[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          Jp[a][0] = d[a][0];
          Jp[a][1] = d[a][1];
          Jp[a][2] = d[a][2];
          Jp[a][3] = -d[a][1] * xc2 + d[a][2] * xc1;
          Jp[a][4] = d[a][0] * xc2 - d[a][2] * xc0;
          Jp[a][5] = -d[a][0] * xc1 + d[a][1] * xc0;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            Jl[a][j] = d[a][0] * ps[j] + d[a][1] * ps[3 + j] + d[a][2] * ps[6 + j];
          const float fr = ps[12];
#pragma unroll
          for (int i = 0; i < 6; ++i) Jp[a][i] *= fr;
        }

#pragma unroll
        for (int i = 0; i < 3; ++i) {
          blv[i] += Jl[0][i] * w * r[0] + Jl[1][i] * w * r[1] + Jl[2][i] * w * r[2];
#pragma unroll
          for (int j = 0; j < 3; ++j)
            hll[3 * i + j] += Jl[0][i] * w * Jl[0][j] + Jl[1][i] * w * Jl[1][j] +
                              Jl[2][i] * w * Jl[2][j];
        }
        float* Ue = U + e * 18;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            Ue[3 * i + j] = Jp[0][i] * w * Jl[0][j] + Jp[1][i] * w * Jl[1][j] +
                            Jp[2][i] * w * Jl[2][j];
#pragma unroll
          for (int j = 0; j < 6; ++j)
            vals[6 * i + j] = Jp[0][i] * w * Jp[0][j] + Jp[1][i] * w * Jp[1][j] +
                              Jp[2][i] * w * Jp[2][j];
          vals[36 + i] = Jp[0][i] * w * r[0] + Jp[1][i] * w * r[1] + Jp[2][i] * w * r[2];
        }
      }
    }

    if constexpr (!kChi2Only) {
      // Camera-keyed block sum of this slot, in thread order.
#pragma unroll
      for (int i = 0; i < kEntries; ++i) s_slot[tid * kEntries + i] = vals[i];
      s_cam[tid] = cam;
      __syncthreads();
      if (tid < kEntries) {
        for (int j = 0; j < kThreads; ++j)
          s_acc[s_cam[j] * kEntries + tid] += s_slot[j * kEntries + tid];
      }
      __syncthreads();
    }
  }

  if constexpr (!kChi2Only) {
    if (live) {
#pragma unroll
      for (int i = 0; i < 9; ++i) Hll[l * 9 + i] = hll[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) bl[l * 3 + i] = blv[i];
    }
  }
  s_chi[tid] = chi;
  __syncthreads();
  const int row_len = n_acc + 1;
  float* row = partial + (size_t)blockIdx.x * row_len;
  for (int i = tid; i < n_acc; i += kThreads) row[i] = s_acc[i];
  if (tid == 0) {
    float c = 0.f;
    for (int j = 0; j < kThreads; ++j) c += s_chi[j];
    row[n_acc] = c;
  }
}

// Sum the per-block partial rows in block order (deterministic). K3 passes
// P = 0: its rows hold the chi2 alone.
__global__ void ba_reduce_kernel(const float* __restrict__ partial, int n_blocks, int P,
                                 float* __restrict__ Hpp, float* __restrict__ bp,
                                 float* __restrict__ chi2) {
  const int row_len = P * kEntries + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= row_len) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * row_len + i];
  if (i == P * kEntries) {
    chi2[0] = s;
  } else {
    const int p = i / kEntries, en = i % kEntries;
    if (en < 36) Hpp[p * 36 + en] = s;
    else bp[p * 6 + (en - 36)] = s;
  }
}

size_t smem_bytes(int P, bool chi2_only) {
  const size_t per_pose = chi2_only ? kPose : kPose + kEntries;
  const size_t per_thread = chi2_only ? 1 : kEntries + 2;
  return sizeof(float) * ((size_t)P * per_pose + kThreads * per_thread);
}

template <bool kChi2Only>
int launch(const void* pose_R, const void* pose_t, const void* pose_free, const void* points,
           const void* obs_cam, const void* obs_uvr, const void* w_active, int P, int L,
           int K, float fx, float fy, float cx, float cy, float bf, int robust, float delta,
           void* Hll, void* bl, void* U, void* partial, void* Hpp, void* bp, void* chi2,
           cudaStream_t s) {
  const size_t smem = smem_bytes(P, kChi2Only);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ba_assembly_kernel<kChi2Only>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_blocks = (L + kThreads - 1) / kThreads;
  if (n_blocks > 0) {
    ba_assembly_kernel<kChi2Only><<<n_blocks, kThreads, smem, s>>>(
        static_cast<const float*>(pose_R), static_cast<const float*>(pose_t),
        static_cast<const float*>(pose_free), static_cast<const float*>(points),
        static_cast<const int32_t*>(obs_cam), static_cast<const float*>(obs_uvr),
        static_cast<const float*>(w_active), P, L, K, fx, fy, cx, cy, bf, robust, delta,
        static_cast<float*>(Hll), static_cast<float*>(bl), static_cast<float*>(U),
        static_cast<float*>(partial));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int P_rows = kChi2Only ? 0 : P;
  const int row_len = P_rows * kEntries + 1;
  ba_reduce_kernel<<<(row_len + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), n_blocks, P_rows, static_cast<float*>(Hpp),
      static_cast<float*>(bp), static_cast<float*>(chi2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs for P poses (K2, or K3 when chi2_only != 0);
// the wrapper checks it against the device limit before launching.
extern "C" size_t ba_assembly_smem_bytes(int P, int chi2_only) {
  return smem_bytes(P, chi2_only != 0);
}

// Opt-in shared-memory limit of one block on `device` (bytes; -1 on error).
extern "C" int ba_assembly_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

// Landmarks per block: the wrapper sizes the partial scratch as
// ceil(L / threads) rows of (P * 42 + 1) floats for K2, of 1 float for K3.
extern "C" int ba_assembly_threads() { return kThreads; }

// K2: launch both passes on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ba_assembly_launch(
    const void* pose_R, const void* pose_t, const void* pose_free, const void* points,
    const void* obs_cam, const void* obs_uvr, const void* w_active, int P, int L, int K,
    float fx, float fy, float cx, float cy, float bf, int robust, float delta,
    void* Hll, void* bl, void* U, void* partial, void* Hpp, void* bp, void* chi2,
    void* stream) {
  return launch<false>(pose_R, pose_t, pose_free, points, obs_cam, obs_uvr, w_active, P, L,
                       K, fx, fy, cx, cy, bf, robust, delta, Hll, bl, U, partial, Hpp, bp,
                       chi2, static_cast<cudaStream_t>(stream));
}

// K3: the chi2-only instance, both passes on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int ba_chi2_launch(
    const void* pose_R, const void* pose_t, const void* points, const void* obs_cam,
    const void* obs_uvr, const void* w_active, int P, int L, int K, float fx, float fy,
    float cx, float cy, float bf, int robust, float delta, void* partial, void* chi2,
    void* stream) {
  return launch<true>(pose_R, pose_t, nullptr, points, obs_cam, obs_uvr, w_active, P, L, K,
                      fx, fy, cx, cy, bf, robust, delta, nullptr, nullptr, nullptr, partial,
                      nullptr, nullptr, chi2, static_cast<cudaStream_t>(stream));
}
