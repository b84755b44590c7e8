"""K2 and K3: bucketed-BA assembly and the residual-only chi2.

Counterpart of `sqrtlm_slam_tpu/optim/assembly_pallas.py`. For every
(landmark, slot) of a landmark-bucketed problem K2 evaluates the stereo/mono
reprojection residual and Jacobians and emits everything the sqrt-Schur
step needs: per-landmark Hll (L,3,3) and bl (L,3), per-slot U = Jp^T w Jl
(L,K,6,3), per-camera Hpp (P,6,6) and bp (P,6), and the robust chi2 sum.
K3 (`chi2_sum`) is the robust chi2 alone, with the same projection, loss
and summation order: the LM candidate test of global BA.

`assemble` and `chi2_sum` dispatch by tensor device only: CPU tensors take
the plain PyTorch versions (`edge_terms` + `reductions`, the math of the JAX
package's `schur_bucketed._edge_terms` + `reductions_from_terms`; K3's is
`edge_terms(...)[4]`); CUDA tensors launch the hand-written kernels of
`csrc/ba_assembly.cu` or raise. K2 there is a landmark pass and a camera
pass; the camera pass walks each camera's slots from a `segment.KeyGroups`
of the active slots (the caller's, or one built per call). The TPU layouts
(landmarks on 128 lanes, one-hot MXU gathers, `L % 128`) are not carried
over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..factors import reprojection as reproj
from ..geometry import se3
from ..ops import build
from ..utils import cache
from . import loss as losses
from . import segment

# Number of K2 and of K3 launches in this process (reset by callers that
# count; a captured graph adds its launches at each replay, `utils.cache`).
launch_count = 0
chi2_launch_count = 0


class AssemblyOut(NamedTuple):
    Hll: torch.Tensor  # (L, 3, 3)
    bl: torch.Tensor  # (L, 3)
    U: torch.Tensor  # (L, K, 6, 3)
    Hpp: torch.Tensor  # (P, 6, 6)
    bp: torch.Tensor  # (P, 6)
    chi2: torch.Tensor  # ()


def edge_terms(pose_R, pose_t, points, obs_cam, obs_uvr, w_info, cam: reproj.Camera,
               robust_delta: Optional[float]):
    """Per-slot (r, Jp, Jl, w, chi2, e2) with mono/stereo unified, (L, K, ...).

    `w_info` is inv_sigma2 * active per slot; inactive slots carry 0."""
    cam_idx = obs_cam.long()
    T = se3.SE3(pose_R[cam_idx], pose_t[cam_idx])
    X = points[:, None, :]
    is_stereo = obs_uvr[..., 2] >= 0.0
    r, Jp, Jl = reproj.stereo_residual_jac(T, X, obs_uvr, cam)
    ones = torch.ones_like(is_stereo)
    row_mask = torch.stack([ones, ones, is_stereo], dim=-1).to(r.dtype)
    r = r * row_mask
    Jp = Jp * row_mask[..., None]
    Jl = Jl * row_mask[..., None]
    e2 = w_info * torch.sum(r * r, dim=-1)
    if robust_delta is None:
        w_rob = torch.ones_like(e2)
        rho = e2
    else:
        rho, w_rob, _ = losses.huber(robust_delta)(e2)
    w = w_info * w_rob
    chi2 = torch.sum(torch.where(w_info > 0, rho, torch.zeros_like(rho)))
    return r, Jp, Jl, w, chi2, e2


def reductions(terms, obs_cam, pose_free, P: int) -> AssemblyOut:
    """Mu-independent reductions (Hll, bl, U, Hpp, bp, chi2) from edge terms."""
    r, Jp, Jl, w, chi2 = terms[:5]
    L, K = obs_cam.shape
    cam_idx = obs_cam.long()
    Jp = Jp * pose_free[cam_idx][..., None, None].to(r.dtype)
    Hll = torch.einsum("lkri,lk,lkrj->lij", Jl, w, Jl)
    bl = torch.einsum("lkri,lk,lkr->li", Jl, w, r)
    U = torch.einsum("lkri,lk,lkrj->lkij", Jp, w, Jl)
    # Camera-keyed sums as a one-hot matmul (a fixed summation order); the
    # one-hot by comparison (`one_hot` checks its classes on the host).
    O = (cam_idx.reshape(-1, 1) == torch.arange(P, device=r.device)).to(r.dtype)  # (L*K, P)
    Hpp = (O.T @ torch.einsum("lkri,lk,lkrj->lkij", Jp, w, Jp).reshape(L * K, 36))
    bp = O.T @ torch.einsum("lkri,lk,lkr->lki", Jp, w, r).reshape(L * K, 6)
    return AssemblyOut(Hll, bl, U, Hpp.reshape(P, 6, 6), bp, chi2)


def assemble_plain(pose_R, pose_t, pose_free, points, obs_cam, obs_uvr, w_active,
                   cam: reproj.Camera, robust_delta: Optional[float]) -> AssemblyOut:
    """Plain PyTorch version of K2 (any device)."""
    terms = edge_terms(pose_R, pose_t, points, obs_cam, obs_uvr, w_active, cam,
                       robust_delta)
    return reductions(terms, obs_cam, pose_free, pose_R.shape[0])


def excess_over_plain(got: AssemblyOut, pose_R, pose_t, pose_free, points, obs_cam,
                      obs_uvr, w_active, cam: reproj.Camera, robust_delta: Optional[float],
                      rtol: float = 5e-3, atol: float = 5e-4,
                      camera_sums: bool = False) -> dict:
    """Hold a K2 result against the plain version evaluated in float64 on the
    same inputs. Returns {output: (worst excess, elements past rtol/atol)};
    a worst excess <= 0 passes.

    Every output must lie within atol + rtol*|ref|, except that an element
    of the landmark-local sums Hll and bl may also lie within the float32
    summation bound gamma * sum|terms| (gamma = (3K + 8) * eps32): where the
    3K terms of such a sum nearly cancel, no float32 evaluation meets 5e-4
    absolute (at the bench shape the float32 plain version itself misses it
    by 3e-4). By Cauchy-Schwarz, sum|terms| <= sqrt(Hll_ii * E_l) for bl_i
    and <= sqrt(Hll_ii * Hll_jj) for Hll_ij, with E_l = sum_k w |r|^2.

    `camera_sums` admits the same bound for the camera sums Hpp and bp, with
    gamma = (3 n_p + 8) * eps32 for the n_p active slots of camera p. It is
    for problems with hundreds of slots per camera: there an off-diagonal
    Hpp entry can cancel from terms of 1e5 to a few hundredths, and the
    float32 plain version misses atol too (by 5e-3 at (1400, 60000, 7)
    with Huber)."""
    f64 = torch.float64
    args64 = [a.to(f64) if a.is_floating_point() else a
              for a in (pose_R, pose_t, pose_free, points, obs_cam, obs_uvr, w_active)]
    terms = edge_terms(args64[0], args64[1], args64[3], args64[4], args64[5], args64[6],
                       cam, robust_delta)
    ref = reductions(terms, args64[4], args64[2], pose_R.shape[0])
    r, w = terms[0], terms[3]
    E = torch.sum(w * torch.sum(r * r, dim=-1), dim=-1)  # (L,)
    d = torch.diagonal(ref.Hll, dim1=-2, dim2=-1).clamp(min=0)  # (L, 3)
    gamma = (3 * obs_cam.shape[1] + 8) * torch.finfo(torch.float32).eps
    extra = {"Hll": gamma * torch.sqrt(d[:, :, None] * d[:, None, :]),
             "bl": gamma * torch.sqrt(d * E[:, None])}
    if camera_sums:
        P = pose_R.shape[0]
        c = args64[4].reshape(-1).long()
        active = (w > 0).reshape(-1)
        n_p = torch.bincount(c[active], minlength=P).to(f64)
        E_p = torch.zeros(P, dtype=f64, device=w.device).index_add_(
            0, c, (w * torch.sum(r * r, dim=-1)).reshape(-1))
        g_p = ((3 * n_p + 8) * torch.finfo(torch.float32).eps)[:, None]
        dp = torch.diagonal(ref.Hpp, dim1=-2, dim2=-1).clamp(min=0)  # (P, 6)
        extra["Hpp"] = g_p[..., None] * torch.sqrt(dp[:, :, None] * dp[:, None, :])
        extra["bp"] = g_p * torch.sqrt(dp * E_p[:, None])
    out = {}
    for name, g, p in zip(AssemblyOut._fields, got, ref):
        err = (g.to(f64) - p).abs()
        tol = atol + rtol * p.abs()
        beyond = err > tol
        if name in extra:
            tol = torch.maximum(tol, extra[name])
        out[name] = (float((err - tol).max()) if err.numel() else 0.0, int(beyond.sum()))
    return out


def _check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name}: expected device {device}, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library (built at first use) with its C functions typed."""
    lib = build.load("ba_assembly")
    lib.ba_assembly_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
        + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 8
    )
    lib.ba_assembly_launch.restype = ctypes.c_int
    lib.ba_chi2_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
        + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 4
    )
    lib.ba_chi2_launch.restype = ctypes.c_int
    return lib


def assemble_cuda(pose_R, pose_t, pose_free, points, obs_cam, obs_uvr, w_active,
                  cam: reproj.Camera, robust_delta: Optional[float],
                  groups: segment.KeyGroups) -> AssemblyOut:
    """Launch K2 on the current stream (all inputs on one CUDA device).
    `groups` lists the active slots of `obs_cam` by camera (P keys)."""
    device = points.device
    if device.type != "cuda":
        raise ValueError(f"assemble_cuda: expected CUDA tensors, got {device}")
    P, L, K = pose_R.shape[0], points.shape[0], obs_cam.shape[1]
    f32 = torch.float32
    _check(pose_R, "pose_R", f32, (P, 3, 3), device)
    _check(pose_t, "pose_t", f32, (P, 3), device)
    _check(pose_free, "pose_free", f32, (P,), device)
    _check(points, "points", f32, (L, 3), device)
    _check(obs_cam, "obs_cam", torch.int32, (L, K), device)
    _check(obs_uvr, "obs_uvr", f32, (L, K, 3), device)
    _check(w_active, "w_active", f32, (L, K), device)
    if P < 1 or K < 1:
        raise ValueError(f"assemble_cuda: need P >= 1 and K >= 1, got P={P} K={K}")
    if L * K >= 2**31:  # the camera pass indexes slots l * K + k in int32
        raise ValueError(f"assemble_cuda: L * K = {L * K} slots exceed an int32 index")
    _check(groups.offsets, "groups.offsets", torch.int32, (P + 1,), device)
    _check(groups.members, "groups.members", torch.int32, (L * K,), device)

    lib = _lib()
    threads = lib.ba_assembly_threads()
    fn = lib.ba_assembly_launch
    n_blocks = -(-L // threads)
    Hll = torch.empty((L, 3, 3), dtype=f32, device=device)
    bl = torch.empty((L, 3), dtype=f32, device=device)
    U = torch.empty((L, K, 6, 3), dtype=f32, device=device)
    partial = torch.empty((max(n_blocks, 1),), dtype=f32, device=device)
    Hpp = torch.empty((P, 6, 6), dtype=f32, device=device)
    bp = torch.empty((P, 6), dtype=f32, device=device)
    chi2 = torch.empty((), dtype=f32, device=device)
    robust = robust_delta is not None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            pose_R.data_ptr(), pose_t.data_ptr(), pose_free.data_ptr(), points.data_ptr(),
            obs_cam.data_ptr(), obs_uvr.data_ptr(), w_active.data_ptr(),
            groups.offsets.data_ptr(), groups.members.data_ptr(), P, L, K,
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(cam.bf),
            int(robust), float(robust_delta) if robust else 0.0,
            Hll.data_ptr(), bl.data_ptr(), U.data_ptr(), partial.data_ptr(),
            Hpp.data_ptr(), bp.data_ptr(), chi2.data_ptr(), stream,
        )
    build.check(rc, "ba_assembly_launch")
    cache.count_launch(__name__, "launch_count")
    return AssemblyOut(Hll, bl, U, Hpp, bp, chi2)


def assemble(pose_R, pose_t, pose_free, points, obs_cam, obs_uvr, w_active,
             cam: reproj.Camera, robust_delta: Optional[float],
             groups: Optional[segment.KeyGroups] = None) -> AssemblyOut:
    """K2 dispatch by device: plain version on CPU, the kernel on CUDA.

    pose_free: (P,) bool or float (1 = free); w_active: (L, K) inv_sigma2 *
    active. `groups`: the slots with w_active > 0 grouped by camera
    (`segment.key_groups(obs_cam, P, keep=...)`; groups that also hold
    inactive slots give the same result). The kernel needs them and they
    are built here when none are given; the plain version does not use
    them."""
    device = points.device
    if device.type == "cuda":
        f32 = torch.float32
        if groups is None:
            groups = segment.key_groups(obs_cam, pose_R.shape[0], keep=w_active > 0)
        return assemble_cuda(
            pose_R.to(f32).contiguous(), pose_t.to(f32).contiguous(),
            pose_free.to(f32).contiguous(), points.to(f32).contiguous(),
            obs_cam.to(torch.int32).contiguous(), obs_uvr.to(f32).contiguous(),
            w_active.to(f32).contiguous(), cam, robust_delta, groups,
        )
    if device.type == "cpu":
        return assemble_plain(pose_R, pose_t, pose_free, points, obs_cam, obs_uvr,
                              w_active, cam, robust_delta)
    raise ValueError(f"no BA assembly implementation for device {device}")


# ----------------------------------------------------------------------
# K3: the residual-only robust chi2.
# ----------------------------------------------------------------------


def chi2_plain(pose_R, pose_t, points, obs_cam, obs_uvr, w_active, cam: reproj.Camera,
               robust_delta: Optional[float]) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device): the chi2 of `edge_terms`."""
    return edge_terms(pose_R, pose_t, points, obs_cam, obs_uvr, w_active, cam,
                      robust_delta)[4]


# K3's launch counters, one int32 per (device, stream), 0 between launches:
# the block of a launch that finishes last sums the tile partials and
# resets its stream's counter. Launches on one stream run in order; each
# stream has its own counter, so launches on two streams never share one.
_tickets: dict = {}


def _ticket(stream: int) -> torch.Tensor:
    """The counter of `stream` on the current device."""
    key = (torch.cuda.current_device(), stream)
    t = _tickets.get(key)
    if t is None:  # made on this stream, so ordered before its first use
        t = _tickets.setdefault(key, torch.zeros((), dtype=torch.int32, device="cuda"))
    return t


def chi2_cuda(pose_R, pose_t, points, obs_cam, obs_uvr, w_active, cam: reproj.Camera,
              robust_delta: Optional[float]) -> torch.Tensor:
    """Launch K3 on the current stream (all inputs on one CUDA device): one
    kernel launch, no pose cap."""
    device = points.device
    if device.type != "cuda":
        raise ValueError(f"chi2_cuda: expected CUDA tensors, got {device}")
    P, L, K = pose_R.shape[0], points.shape[0], obs_cam.shape[1]
    f32 = torch.float32
    _check(pose_R, "pose_R", f32, (P, 3, 3), device)
    _check(pose_t, "pose_t", f32, (P, 3), device)
    _check(points, "points", f32, (L, 3), device)
    _check(obs_cam, "obs_cam", torch.int32, (L, K), device)
    _check(obs_uvr, "obs_uvr", f32, (L, K, 3), device)
    _check(w_active, "w_active", f32, (L, K), device)
    if P < 1 or K < 1:
        raise ValueError(f"chi2_cuda: need P >= 1 and K >= 1, got P={P} K={K}")

    lib = _lib()
    n_tiles = -(-L // lib.ba_assembly_threads())
    partial = torch.empty((max(n_tiles, 1),), dtype=f32, device=device)
    chi2 = torch.empty((), dtype=f32, device=device)
    robust = robust_delta is not None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ticket = _ticket(stream)
        rc = lib.ba_chi2_launch(
            pose_R.data_ptr(), pose_t.data_ptr(), points.data_ptr(), obs_cam.data_ptr(),
            obs_uvr.data_ptr(), w_active.data_ptr(), P, L, K,
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(cam.bf),
            int(robust), float(robust_delta) if robust else 0.0,
            partial.data_ptr(), ticket.data_ptr(), chi2.data_ptr(), stream,
        )
    build.check(rc, "ba_chi2_launch")
    cache.count_launch(__name__, "chi2_launch_count")
    return chi2


def chi2_sum(pose_R, pose_t, points, obs_cam, obs_uvr, w_active, cam: reproj.Camera,
             robust_delta: Optional[float]) -> torch.Tensor:
    """K3 dispatch by device: robust chi2 of the bucketed problem, () float32
    (plain version on CPU, the kernel on CUDA). w_active: (L, K)
    inv_sigma2 * active."""
    device = points.device
    if device.type == "cuda":
        f32 = torch.float32
        return chi2_cuda(
            pose_R.to(f32).contiguous(), pose_t.to(f32).contiguous(),
            points.to(f32).contiguous(), obs_cam.to(torch.int32).contiguous(),
            obs_uvr.to(f32).contiguous(), w_active.to(f32).contiguous(), cam, robust_delta,
        )
    if device.type == "cpu":
        return chi2_plain(pose_R, pose_t, points, obs_cam, obs_uvr, w_active, cam,
                          robust_delta)
    raise ValueError(f"no chi2 implementation for device {device}")
