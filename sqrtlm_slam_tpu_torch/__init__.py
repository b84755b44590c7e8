"""sqrtlm_slam_tpu_torch — the PyTorch/CUDA port of sqrtlm_slam_tpu.

The JAX package (`sqrtlm_slam_tpu`) is the reference; this package mirrors
its module names and layout so each counterpart is found at the same path
(`geometry/se3.py` <-> `geometry/se3.py`, ...). It imports `torch` and never
`jax`.

Ported so far: the RGB-D main path — ORB extraction, projection-window
matching, pose-only LM tracking, keyframe insertion into the shared numpy
`MapStore` (with vocabulary words and BoW), and local mapping with the
bucketed sqrt-Schur local BA — and the loop path: place recognition, Sim3
verification, loop correction, the Sim3 essential graph and the
matrix-free PCG global BA; the failure path: PnP RANSAC, the no-prior pose
recovery, relocalisation, map checkpoint and resume, localisation mode; and
camera+LiDAR fusion (`SlamSystem.track_fusion`): LiDAR feature extraction
on the range image, voxel-hash association, the tightly coupled pose
optimisation in tracking and the LiDAR stage of local BA; stereo
(`SlamSystem.track_stereo`) and monocular (`SlamSystem.track_monocular`, the
two-view H/F initializer) tracking; and standalone LiDAR odometry
(`lidar/odometry.py::LidarOdometry`) with its SE(3) pose-graph backend;
and the KITTI runner (`python -m sqrtlm_slam_tpu_torch.run_kitti`) with
what it drives: KITTI IO, the native prefetching loader, the KITTI-layout
generator, the asynchronous mapping worker and pipelined tracking. The
LiDAR code and the initializer are plain PyTorch (they are XLA, not Pallas,
in the JAX package).

Every TPU kernel on that path is a hand-written CUDA kernel under `csrc/`,
built with nvcc at first use (`ops/build.py`) and bound through ctypes:

  K1  csrc/hamming.cu      <- ops/hamming.py::hamming_matrix_pallas
  K2  csrc/ba_assembly.cu  <- optim/assembly_pallas.py::_assemble_raw
  K3  csrc/ba_assembly.cu  <- optim/assembly_pallas.py::chi2_prepared
      (K2's kernel compiled with kChi2Only = true)

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
a CUDA tensor launches the kernel or raises.

Package layout
--------------
  geometry/   SO3 / SE3 / Sim3 Lie ops, Umeyama alignment
  factors/    reprojection and LiDAR residuals + Jacobians, the SE3 and
              Sim3 pose-graph factors, LiDAR-camera extrinsic calibration
  algorithm/  PnP RANSAC banks (2D-3D DLT, 3D-3D Horn)
  lidar/      range-image features, voxel-hash NN + downsampling, local map,
              scan-to-map odometry, SE3 pose-graph backend
  optim/      robust losses, LM, pose-only optimisation, BA assembly (K2) and
              chi2 (K3), bucketed sqrt-Schur local BA, matrix-free PCG global
              BA, fixed-order keyed sums, optimizer facade
  ops/        Hamming kernel wrapper (K1), nvcc + ctypes kernel build
  frontend/   ORB extraction, descriptor matching, vocabulary + BoW
  pipeline/   frame build (RGB-D, stereo, fusion), tracking, the monocular
              initializer, triangulation, local mapping, system
  loop/       keyframe database, Sim3 RANSAC, essential graph, loop closer
  mapstore/   the JAX package's numpy MapStore, carried over unchanged;
              the map checkpoint (same npz layout as the JAX package's)
  eval/       numpy synthetic worlds (points, textured planes + LiDAR
              scanner), BA problems, the scale store, ATE / RPE, the
              KITTI-layout generator, long runs, plots
  io/         KITTI reader and trajectory writer, zlib PNG codec, the
              native prefetching loader (ctypes, built with g++)
  utils/      host reads (`to_host`), sequence config, stage timer, Kalman
  run_kitti.py  the KITTI runner (four modes)
  convert.py  JAX-package objects -> port objects (parity tests)
"""

__version__ = "0.1.0"
