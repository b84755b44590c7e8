"""sqrtlm_slam_tpu_torch — the PyTorch/CUDA port of sqrtlm_slam_tpu.

The JAX package (`sqrtlm_slam_tpu`) is the reference; this package mirrors
its module names and layout so each counterpart is found at the same path
(`geometry/se3.py` <-> `geometry/se3.py`, ...). It imports `torch` and never
`jax`.

Ported so far: the RGB-D main path — ORB extraction, projection-window
matching, pose-only LM tracking, keyframe insertion into the shared numpy
`MapStore`, and local mapping with the bucketed sqrt-Schur local BA.

Every TPU kernel on that path is a hand-written CUDA kernel under `csrc/`,
built with nvcc at first use (`ops/build.py`) and bound through ctypes:

  K1  csrc/hamming.cu      <- ops/hamming.py::hamming_matrix_pallas
  K2  csrc/ba_assembly.cu  <- optim/assembly_pallas.py::_assemble_raw

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
a CUDA tensor launches the kernel or raises.

Package layout
--------------
  geometry/   SO3 / SE3 Lie ops
  factors/    reprojection residuals + Jacobians
  optim/      robust losses, LM, pose-only optimisation, BA assembly (K2),
              bucketed sqrt-Schur local BA, optimizer facade
  ops/        Hamming kernel wrapper (K1), nvcc + ctypes kernel build
  frontend/   ORB extraction, descriptor matching
  pipeline/   frame build, tracking, triangulation, local mapping, system
  mapstore/   the JAX package's numpy MapStore, carried over unchanged
  eval/       numpy synthetic world + BA problem generator, ATE
  convert.py  JAX-package objects -> port objects (parity tests)
"""

__version__ = "0.1.0"
