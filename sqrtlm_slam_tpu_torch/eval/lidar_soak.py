"""The LiDAR soak: LiDAR-only odometry over the `kitti_synth` sequence
(1,000 scans of 64 x 1800 rays along the 383 m street circuit: 1.68 laps,
the corners driven at 0.45 x the step; the first lap ends at scan 598),
counted as it runs, and the gates that hold one run against another.

Three runs make the record, each on either package's `LidarOdometry`
(`scripts/lidar_soak_reference.py` drives either on the CPU; `chip_smoke.py`
phase 21 drives the port on the card):

  (a) slam: `run_kitti --mode lidar` (the `lidar_slam` node's front end:
      the 30-keyframe window) over every scan;
  (b) mapping, then localization: `mode="mapping"` (unbounded map) over
      the first lap, then a fresh odometry with `set_prior_map` of every
      mapping keyframe's world-frame clouds, localizing over every scan
      from frame 0;
  (c) the backends over (a)'s chain: `backend_for_loop(j, last, T_ji)`
      (j the first-lap scan nearest the last one by ground truth, T_ji
      their true relative pose) and `backend_for_gnss` with ground-truth
      positions every 100 scans (the graph takes the first `A_CAP`).

`Recorder` wraps a `LidarOdometry` class's `process` (and the package's
`align_scan`, for its stats) for the length of a `with` block. It takes
the class and module as arguments, so one recorder counts either package.
Per scan: the pose T_lw, whether a keyframe was inserted, the
associations (sharp + flat: `align_scan`'s `matches`); per keyframe the
occupied voxels of each class in the window before the map's capacity cut
(`occupied_voxels`); every `every` scans a reading with the ATE so far.
`result()` gives the record the gates read:

    scans, keyframes, keyframe_scans, ate_rmse_m, ate_m_of_first {100,
    200, 300, 500}, ate_m_by_lap, lap_starts, end_drift_m, lost_at,
    matches (min, median, per scan), voxels [(scan, corner, flat,
    clipped)], peak_rss_mb, wall_s, progress [`reading()` every `every`
    scans]; `poses_lw()` the (N, 3, 4) T_lw of every scan.

Imports neither JAX nor torch at module level: device tensors are read
through the recorder's `host` function, and the voxel counts of torch
tensors are made on their device (`occupied_voxels`).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from .ate import ate_rmse
from . import soak
from .kitti_soak import read_gt
from .soak import peak_rss_mb

PREFIXES = (100, 200, 300, 500)
A_CAP = 8  # anchors `build_chain_graph` takes (both packages' default)
GNSS_EVERY = 100
# A scan with fewer associations has lost the map: both packages' slam runs
# over the sequence never fall below 71 (the first corner, scans 73-92,
# 90-200), their localization runs against the capped prior map below 30
# from scan ~117 on and to 0 after (PERF.md section 5).
LOST_MATCHES = 30
# The map's voxel key (lidar/voxel_map.py, both packages): 10 bits an axis,
# x-major, coordinates clamped to +-512 cells.
COORD_BITS = 10


# -- the sequence ------------------------------------------------------------

def read_tr(root: str, seq: str = "00") -> np.ndarray:
    """(4, 4) T_cam_velo, the `Tr` row of the sequence's calib.txt."""
    with open(os.path.join(root, "sequences", seq, "calib.txt")) as f:
        for line in f:
            if line.startswith("Tr:"):
                T = np.eye(4)
                T[:3, :] = np.array(line.split()[1:], float).reshape(3, 4)
                return T
    raise ValueError("calib.txt has no Tr row")


def lidar_gt(root: str, seq: str = "00") -> np.ndarray:
    """(F, 4, 4) LiDAR -> world of every scan, world = the first scan's
    LiDAR frame (where the odometry starts, at the identity)."""
    T_cv = read_tr(root, seq)
    T_wl = read_gt(root, seq) @ T_cv
    return np.linalg.inv(T_wl[0]) @ T_wl


def scan(root: str, i: int, seq: str = "00") -> np.ndarray:
    """Scan i's (N, 3) float32 points, as both runners read them."""
    path = os.path.join(root, "sequences", seq, "velodyne", f"{i:06d}.bin")
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]


def scan_digest(root: str, frames: int, seq: str = "00") -> str:
    """sha256 over calib.txt, the first `frames` poses and scans: equal
    digests, the same input bytes (with or without the images)."""
    import hashlib

    h = hashlib.sha256()
    with open(os.path.join(root, "poses", seq + ".txt"), "rb") as f:
        h.update(b"".join(f.readlines()[:frames]))
    seq_dir = os.path.join(root, "sequences", seq)
    paths = [os.path.join(seq_dir, "calib.txt")] + [
        os.path.join(seq_dir, "velodyne", f"{i:06d}.bin") for i in range(frames)]
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def lap_starts(gt_l: np.ndarray) -> list:
    """First scan of each lap: where the distance travelled (summed steps
    between ground-truth positions) passes a multiple of the circuit's
    perimeter (`planeworld.circuit_trajectory`'s, A=60, B=40, r=10)."""
    perim = 2 * 2 * (40.0 - 10.0) + 2 * 2 * (60.0 - 10.0) + 2 * math.pi * 10.0
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(gt_l[:, :3, 3], axis=0),
                                                        axis=1))])
    return [0] + [int(np.argmax(s >= k * perim)) for k in range(1, int(s[-1] // perim) + 1)]


def first_lap(gt_l: np.ndarray) -> int:
    """Scans of the first lap (all of them where the sequence ends sooner)."""
    starts = lap_starts(gt_l)
    return starts[1] if len(starts) > 1 else len(gt_l)


def loop_pair(gt_l: np.ndarray, last: int) -> int:
    """The first-lap scan nearest scan `last` by ground truth; scan 0 while
    `last` is still on the first lap."""
    n1 = first_lap(gt_l)
    if last < n1:
        return 0
    d = np.linalg.norm(gt_l[:n1, :3, 3] - gt_l[last, :3, 3], axis=1)
    return int(np.argmin(d))


def relative(gt_l: np.ndarray, i: int, j: int) -> np.ndarray:
    """True T_ji (frame i -> frame j) of two scans, (4, 4)."""
    return np.linalg.inv(gt_l[j]) @ gt_l[i]


def gnss_anchors(gt_l: np.ndarray, n: int, every: int = GNSS_EVERY) -> list:
    """[(scan, its true LiDAR position)] every `every` scans of the first n."""
    return [(k, gt_l[k, :3, 3].astype(np.float32)) for k in range(0, n, every)]


# -- voxels ------------------------------------------------------------------

def occupied_voxels(points, valid, cell: float):
    """(occupied voxels, points clamped by the key's range) of the valid
    points under the map's key (`voxel_map._voxel_key`): what the
    downsample keeps before its capacity. Torch tensors are counted on
    their device and come back as 0-dim tensors (no read); anything else
    through numpy."""
    off, mask = 1 << (COORD_BITS - 1), (1 << COORD_BITS) - 1
    if type(points).__module__.startswith("torch"):
        import torch

        valid = valid & torch.isfinite(points).all(-1)
        ijk = torch.floor(torch.nan_to_num(points) / cell).to(torch.int64) + off
        clipped = torch.sum(((ijk < 0) | (ijk > mask)).any(-1) & valid)
        q = torch.clamp(ijk, 0, mask)
        key = (q[:, 0] << (2 * COORD_BITS)) | (q[:, 1] << COORD_BITS) | q[:, 2]
        key = torch.sort(torch.where(valid, key, torch.full_like(key, -1)))[0]
        first = torch.ones_like(valid)
        first[1:] = key[1:] != key[:-1]
        return torch.sum(first & (key >= 0)), clipped
    p, v = np.asarray(points, np.float32), np.asarray(valid, bool)
    v = v & np.isfinite(p).all(-1)
    ijk = np.floor(np.nan_to_num(p) / np.float32(cell)).astype(np.int64) + off
    clipped = int((((ijk < 0) | (ijk > mask)).any(-1) & v).sum())
    q = np.clip(ijk, 0, mask)[v]
    key = (q[:, 0] << (2 * COORD_BITS)) | (q[:, 1] << COORD_BITS) | q[:, 2]
    return int(len(np.unique(key))), clipped


def window_voxels(odo, cell: float):
    """(corner, flat, clipped) occupied voxels of the odometry's keyframe
    window (its clouds before the downsample)."""
    cat = _cat_for(odo._kf_corner[0][0])
    c, cc = occupied_voxels(cat([p for p, _ in odo._kf_corner]),
                            cat([v for _, v in odo._kf_corner]), cell)
    f, fc = occupied_voxels(cat([p for p, _, _ in odo._kf_flat]),
                            cat([v for _, v, _ in odo._kf_flat]), cell)
    return c, f, cc + fc


def _cat_for(x):
    if type(x).__module__.startswith("torch"):
        import torch

        return torch.cat
    return np.concatenate


def prior_map(odo, host) -> dict:
    """Every keyframe's world-frame clouds of a mapping run, as numpy: the
    arguments of `set_prior_map` (corner_w, corner_valid, flat_w,
    flat_valid, flat_normals_w)."""
    def cat(xs):
        return np.concatenate([np.asarray(host(x)) for x in xs])

    return dict(corner_w=cat([p for p, _ in odo._kf_corner]),
                corner_valid=cat([v for _, v in odo._kf_corner]),
                flat_w=cat([p for p, _, _ in odo._kf_flat]),
                flat_valid=cat([v for _, v, _ in odo._kf_flat]),
                flat_normals_w=cat([n for _, _, n in odo._kf_flat]))


def prior_map_voxels(prior: dict, local_map, cfg, host) -> dict:
    """The prior map's occupied voxels of each class against the capacity,
    and what the local map kept of them (its valid rows)."""
    c, cc = occupied_voxels(prior["corner_w"], prior["corner_valid"], cfg.downsample_cell)
    f, fc = occupied_voxels(prior["flat_w"], prior["flat_valid"], cfg.downsample_cell)
    return dict(corner_occupied=c, flat_occupied=f, clipped=cc + fc,
                corner_kept=int(np.asarray(host(local_map.corner.valid)).sum()),
                flat_kept=int(np.asarray(host(local_map.flat.valid)).sum()),
                capacity=cfg.map_capacity,
                corner_points=int(prior["corner_valid"].sum()),
                flat_points=int(prior["flat_valid"].sum()))


# -- the recorder ------------------------------------------------------------

def to_matrix(R, t) -> np.ndarray:
    M = np.eye(4)
    M[:3, :3], M[:3, 3] = R, t
    return M


class Recorder(soak.Recorder):
    """Counts a LiDAR odometry run while it is inside the `with` block; see
    the module docstring. `odometry_cls` / `odometry_mod`: the package's
    `LidarOdometry` and its module (whose `align_scan` is wrapped for its
    stats). `gt_l`: `lidar_gt` of the sequence. `host(x)` reads an array
    of the package to numpy; `log(str)` takes the progress lines. With
    `record_chain`, `record_pose` follows every scan (the backend's
    chain). With `sync` (a function that waits for the device), each
    scan's `process` is timed between two calls of it (`ms`); the
    recorder's own readings fall outside. `on_scan(scan index)` is called
    after each scan is counted, before its progress reading."""

    def __init__(self, odometry_cls, odometry_mod, gt_l: np.ndarray, host, every: int = 100,
                 log=print, record_chain: bool = False, sync=None, on_scan=None):
        super().__init__(every, log)
        self.cls, self.mod = odometry_cls, odometry_mod
        self.gt_l, self.host = gt_l, host
        self.record_chain, self.sync, self.on_scan = record_chain, sync, on_scan
        self.odo = None
        self.poses = []  # per scan: (R, t) of the package, read in batches
        self.matches = []  # per scan: align_scan's matches (None: the first scan)
        self.keyframe = []  # per scan: a keyframe inserted
        self.voxels = []  # (scan, corner, flat, clipped) at every keyframe
        self.ms = []  # per scan, with `sync`
        self._last_stats = None
        self._pending = 0  # scans not yet read to the host

    def install(self):
        rec = self

        def align_scan(fn):
            def call(*a, **k):
                pose, stats = fn(*a, **k)
                rec._last_stats = stats
                return pose, stats
            return call

        def process(fn):
            def call(self, *a, **k):
                rec.odo = self
                kf0 = self.num_keyframes
                rec._last_stats = None
                if rec.sync is not None:
                    rec.sync()
                    t0 = time.perf_counter()
                out = fn(self, *a, **k)
                if rec.sync is not None:
                    rec.sync()
                    rec.ms.append(1e3 * (time.perf_counter() - t0))
                if rec.record_chain:
                    self.record_pose()
                rec._scan_done(self, self.num_keyframes > kf0)
                return out
            return call

        self.patch(self.mod, "align_scan", align_scan)
        self.patch(self.cls, "process", process)

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._read()
        return False

    def _scan_done(self, odo, keyframe: bool):
        self.poses.append((odo.pose.R, odo.pose.t))
        stats = self._last_stats
        self.matches.append(stats["matches"] if stats is not None else None)
        self.keyframe.append(keyframe)
        self._pending += 1
        if keyframe and odo.mode != "localization":
            c, f, clipped = window_voxels(odo, odo.cfg.downsample_cell)
            self.voxels.append([len(self.keyframe) - 1, c, f, clipped])
        if self.on_scan is not None:
            self.on_scan(len(self.keyframe) - 1)
        self.tick(len(self.keyframe))

    def _read(self):
        """Bring the scans' poses, stats and voxel counts to the host."""
        n = self._pending
        if not n:
            return
        lo = len(self.poses) - n
        h = self.host
        for k in range(lo, len(self.poses)):
            R, t = self.poses[k]
            if not isinstance(R, np.ndarray):
                self.poses[k] = (np.asarray(h(R), np.float64), np.asarray(h(t), np.float64))
            m = self.matches[k]
            if m is not None and not isinstance(m, int):
                self.matches[k] = int(np.asarray(h(m)))
        for v in self.voxels:
            v[1:] = [int(np.asarray(h(x))) if not isinstance(x, int) else x for x in v[1:]]
        self._pending = 0

    # -- readings --------------------------------------------------------

    def est_wl(self) -> np.ndarray:
        """(N, 4, 4) LiDAR -> world of every scan so far."""
        self._read()
        return np.linalg.inv(np.stack([to_matrix(R, t) for R, t in self.poses]))

    def summary(self) -> dict:
        est = self.est_wl()
        n = len(est)
        gt = self.gt_l[:n]
        laps = [s for s in lap_starts(self.gt_l) if s < n]
        bounds = laps + [n]
        m = [x for x in self.matches if x is not None]
        finite = np.isfinite(est[:, :3, 3]).all(1)
        lost = int(np.argmin(finite)) if not finite.all() else lost_scan(self.matches)
        return dict(
            scans=n, keyframes=int(sum(self.keyframe)),
            keyframe_scans=[k for k, f in enumerate(self.keyframe) if f],
            ate_rmse_m=ate(est, gt),
            ate_m_of_first={k: ate(est[:k], gt[:k]) for k in PREFIXES if n >= k},
            lap_starts=laps,
            ate_m_by_lap={l: ate(est[a:b], gt[a:b])
                          for l, (a, b) in enumerate(zip(bounds, bounds[1:]))},
            end_drift_m=float(np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])),
            lost_at=lost,
            matches_min=int(min(m)) if m else None,
            matches_median=float(np.median(m)) if m else None,
            voxels_last=self.voxels[-1] if self.voxels else None)

    def reading(self) -> dict:
        return dict(self.summary(), rss_mb=peak_rss_mb(), elapsed_s=self.elapsed_s())

    def progress_line(self, r: dict) -> str:
        return (f"PROGRESS scan={r['scans']} keyframes={r['keyframes']} "
                f"ate_so_far={_fmt(r['ate_rmse_m'])} "
                f"prefix_ate={_rounded(r['ate_m_of_first'])} "
                f"lap_ate={_rounded(r['ate_m_by_lap'])} "
                f"matches_min={r['matches_min']} voxels_last={r['voxels_last']} "
                f"lost_at={r['lost_at']} rss_mb={r['rss_mb']:.0f} "
                f"elapsed_s={r['elapsed_s']:.0f} {time.strftime('%H:%M:%S')}")

    def result(self) -> dict:
        self._read()
        return dict(self.summary(), matches=list(self.matches), voxels=self.voxels,
                    peak_rss_mb=peak_rss_mb(), wall_s=getattr(self, "wall_s", None),
                    ms=self.ms or None, progress=self.progress)

    def poses_lw(self) -> np.ndarray:
        """(N, 3, 4) float64 T_lw of every scan."""
        self._read()
        return np.stack([np.concatenate([R, t[:, None]], 1) for R, t in self.poses])


def lost_scan(matches, scans=None):
    """The first scan (below `scans`) with fewer than LOST_MATCHES
    associations, or None."""
    for k, x in enumerate(matches[:scans]):
        if x is not None and x < LOST_MATCHES:
            return k
    return None


def ate(est: np.ndarray, gt: np.ndarray):
    """SE3-aligned ATE (m) of LiDAR poses, None below 3 scans."""
    return float(ate_rmse(est, gt, align_scale=False)[0]) if len(est) >= 3 else None


def _fmt(x) -> str:
    return "nan" if x is None else f"{x:.4f}"


def _rounded(d: dict) -> dict:
    return {k: None if v is None else round(v, 4) for k, v in d.items()}


# -- the backends -------------------------------------------------------------

def chain_matrices(chain, host) -> np.ndarray:
    """(K, 3, 4) float64 T_lw of a backend chain (a list of SE3)."""
    return np.stack([np.concatenate([np.asarray(host(p.R), np.float64),
                                     np.asarray(host(p.t), np.float64)[:, None]], 1)
                     for p in chain])


def end_drift(chain_lw: np.ndarray, gt_l: np.ndarray) -> float:
    """Position error (m) of a chain's last pose, unaligned (both start at
    the first scan's frame)."""
    M = to_matrix(chain_lw[-1][:, :3], chain_lw[-1][:, 3])
    return float(np.linalg.norm(np.linalg.inv(M)[:3, 3] - gt_l[len(chain_lw) - 1][:3, 3]))


def chain_positions(chain_lw: np.ndarray) -> np.ndarray:
    """(K, 3) sensor centres C = -R^T t of a (K, 3, 4) T_lw chain."""
    R, t = chain_lw[:, :, :3], chain_lw[:, :, 3]
    return -np.einsum("kji,kj->ki", R, t)


# -- gates ---------------------------------------------------------------------

# The gates on a run against the reference run of the same scans (PERF.md
# section 2), each margin from the two CPU records below, the JAX
# package's and the port's:
#   keyframes_tol: both slam runs made the same 318 keyframes on the same
#     scans, both mapping runs 191 (their keyframe scans part at the 82nd);
#     2 %, 6 keyframes of 318, for the rounding of another device;
#   *_ate_factor: the ATE of a prefix or a lap at most 2 x the JAX run's,
#     the largest ratio between the two CPU runs (1.81, slam's second lap:
#     0.2338 against 0.1289 m; the prefixes <= 1.44) rounded up, or the
#     JAX run's + 0.05 m where that is larger (the first 100 scans read
#     ~0.065 m); gated before the scan where the JAX run lost the map;
#   lost_scans: the localization runs lost the map at scans 115 (JAX) and
#     117 (port); 10 scans;
#   MAPPING_GATES: the mapping run's ATE is chaotic in rounding (PERF.md
#     section 7): with its scans scaled by 1 + K x 2^-23 (K = -4..4,
#     `scripts/lidar_soak_reference.py --jitter-ulps K`) the port's CPU lap
#     ATE spreads over 0.554-1.141 m (0.560-0.581 m unscaled, 1-4 threads)
#     and the JAX package's over 0.391-0.929 m (K = -1..1): at most 2.92 x
#     the JAX record's lap (the port, K = 3) and 2.24 x a prefix (the JAX
#     package, K = -1, the first 300 scans); rounded up to the next half;
#   CUT_TOL: a backend's end-drift cut (after / before) at most the JAX
#     run's + this: the port's CPU run cut by 0.403 against 0.382
#     (loop) and 1.309 against 1.100 (gnss: the end drift grows: only 8
#     of 10 anchors are taken), its spread rounded up;
#   BACKEND_TOL_M: each backend on the JAX run's own chain, against its
#     result, at most as far as a float32 solve of that system lands from
#     its float64 answer on the CPU (`scripts/lidar_backend_f64.py`: the
#     damped normal matrix's free block has a condition number of 8.1e6
#     (loop) and 1.2e7 (gnss); the JAX package's float32 result lies 14.1 /
#     43.9 mm from the float64 answer, the port's on the CPU 13.9 / 41.8
#     mm, the two 8.6 mm apart), the larger of the two rounded up to 0.1
#     mm: the card departs from the JAX result by no more than float32
#     departs from the answer (PERF.md section 7);
#   KEPT_VOXELS_TOL: the prior map keeps 8,192 voxels of each class in
#     both packages (the capacity): equal.
GATES = dict(keyframes_tol=0.02, prefix_ate_factor=2.0, prefix_ate_floor_m=0.05,
             lap_ate_factor=2.0, lap_ate_floor_m=0.05, lost_scans=10)
MAPPING_GATES = dict(GATES, prefix_ate_factor=2.5, lap_ate_factor=3.0)
CUT_TOL = {"loop": 0.05, "gnss": 0.25}
BACKEND_TOL_M = {"loop": 0.0142, "gnss": 0.0439}
KEPT_VOXELS_TOL = {"corner": 0, "flat": 0}

# The records (`gated_fields` of the RESULT objects), on an 8-core x86
# CPU over the 1,000 scans of `kitti_synth`'s defaults (scan digest
# f2ea99b9... over 1,000), made by
#     JAX_PLATFORMS=cpu python3 scripts/lidar_soak_reference.py --package jax \
#         --root build/lidar_soak --record build/lidar_jax.json --poses build/lidar_jax.npz
#     OMP_NUM_THREADS=3 python3 scripts/lidar_soak_reference.py --package port \
#         --root build/lidar_soak --record build/lidar_port.json
# (39 and 26 minutes). lidar_soak_jax.npz holds the JAX run's poses of (a)
# and its backends' chains, float32 (K, 3, 4) T_lw: "slam",
# "backend_loop", "backend_gnss".
JAX_RECORD = {
    "slam": dict(scans=1000, keyframes=318, ate_rmse_m=0.432798, ate_m_of_first={100:
             0.0650622, 200: 0.109012, 300: 0.116863, 500: 0.11671}, ate_m_by_lap={0:
             0.125296, 1: 0.233779}, lap_starts=[0, 598], end_drift_m=1.57282,
             lost_at=None, matches_min=71, matches_median=1220.0, voxels_last=[997, 1901,
             15520, 0], flat_voxels_max=22253, corner_voxels_max=2641, progress=[
            dict(scans=100, keyframes=32, ate_rmse_m=0.0650622, ate_m_of_first={100:
                 0.0650622}, ate_m_by_lap={0: 0.0650622}, lap_starts=[0], lost_at=None,
                 matches_min=92),
            dict(scans=200, keyframes=64, ate_rmse_m=0.109012, ate_m_of_first={100:
                 0.0650622, 200: 0.109012}, ate_m_by_lap={0: 0.109012}, lap_starts=[0],
                 lost_at=None, matches_min=92),
            dict(scans=300, keyframes=96, ate_rmse_m=0.116863, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863}, ate_m_by_lap={0: 0.116863},
                 lap_starts=[0], lost_at=None, matches_min=92),
            dict(scans=400, keyframes=127, ate_rmse_m=0.118068, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863}, ate_m_by_lap={0: 0.118068},
                 lap_starts=[0], lost_at=None, matches_min=92),
            dict(scans=500, keyframes=159, ate_rmse_m=0.11671, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863, 500: 0.11671}, ate_m_by_lap={0:
                 0.11671}, lap_starts=[0], lost_at=None, matches_min=92),
            dict(scans=600, keyframes=191, ate_rmse_m=0.125543, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863, 500: 0.11671}, ate_m_by_lap={0:
                 0.125296, 1: None}, lap_starts=[0, 598], lost_at=None, matches_min=92),
            dict(scans=700, keyframes=223, ate_rmse_m=0.220001, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863, 500: 0.11671}, ate_m_by_lap={0:
                 0.125296, 1: 0.169693}, lap_starts=[0, 598], lost_at=None, matches_min=71),
            dict(scans=800, keyframes=255, ate_rmse_m=0.264002, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863, 500: 0.11671}, ate_m_by_lap={0:
                 0.125296, 1: 0.17165}, lap_starts=[0, 598], lost_at=None, matches_min=71),
            dict(scans=900, keyframes=286, ate_rmse_m=0.318087, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863, 500: 0.11671}, ate_m_by_lap={0:
                 0.125296, 1: 0.169616}, lap_starts=[0, 598], lost_at=None, matches_min=71),
            dict(scans=1000, keyframes=318, ate_rmse_m=0.432798, ate_m_of_first={100:
                 0.0650622, 200: 0.109012, 300: 0.116863, 500: 0.11671}, ate_m_by_lap={0:
                 0.125296, 1: 0.233779}, lap_starts=[0, 598], lost_at=None, matches_min=71),
        ]),
    "mapping": dict(scans=598, keyframes=191, ate_rmse_m=0.390843, ate_m_of_first={100:
             0.0665805, 200: 0.156933, 300: 0.241557, 500: 0.366978}, ate_m_by_lap={0:
             0.390843}, lap_starts=[0], end_drift_m=1.11536, lost_at=None,
             matches_min=76, matches_median=530.0, voxels_last=[595, 11613, 87551, 0],
             flat_voxels_max=87551, corner_voxels_max=11613, progress=[
            dict(scans=100, keyframes=32, ate_rmse_m=0.0665805, ate_m_of_first={100:
                 0.0665805}, ate_m_by_lap={0: 0.0665805}, lap_starts=[0], lost_at=None,
                 matches_min=92),
            dict(scans=200, keyframes=64, ate_rmse_m=0.156933, ate_m_of_first={100:
                 0.0665805, 200: 0.156933}, ate_m_by_lap={0: 0.156933}, lap_starts=[0],
                 lost_at=None, matches_min=90),
            dict(scans=300, keyframes=96, ate_rmse_m=0.241557, ate_m_of_first={100:
                 0.0665805, 200: 0.156933, 300: 0.241557}, ate_m_by_lap={0: 0.241557},
                 lap_starts=[0], lost_at=None, matches_min=76),
            dict(scans=400, keyframes=127, ate_rmse_m=0.331401, ate_m_of_first={100:
                 0.0665805, 200: 0.156933, 300: 0.241557}, ate_m_by_lap={0: 0.331401},
                 lap_starts=[0], lost_at=None, matches_min=76),
            dict(scans=500, keyframes=159, ate_rmse_m=0.366978, ate_m_of_first={100:
                 0.0665805, 200: 0.156933, 300: 0.241557, 500: 0.366978}, ate_m_by_lap={0:
                 0.366978}, lap_starts=[0], lost_at=None, matches_min=76),
        ]),
    "localization": dict(scans=1000, keyframes=0, ate_rmse_m=72.3417, ate_m_of_first={100: 0.360583,
             200: 7.35796, 300: 33.2759, 500: 58.4805}, ate_m_by_lap={0: 58.0728, 1:
             66.8492}, lap_starts=[0, 598], end_drift_m=143.383, lost_at=115,
             matches_min=0, matches_median=0.0, voxels_last=None,
             prior_map={'corner_occupied': 11613, 'flat_occupied': 87551, 'clipped': 0,
             'corner_kept': 8192, 'flat_kept': 8192, 'capacity': 8192, 'corner_points':
             75923, 'flat_points': 391048}, mapping_scans=598, progress=[
            dict(scans=100, keyframes=0, ate_rmse_m=0.360583, ate_m_of_first={100: 0.360583},
                 ate_m_by_lap={0: 0.360583}, lap_starts=[0], lost_at=None, matches_min=30),
            dict(scans=200, keyframes=0, ate_rmse_m=7.35796, ate_m_of_first={100: 0.360583,
                 200: 7.35796}, ate_m_by_lap={0: 7.35796}, lap_starts=[0], lost_at=115,
                 matches_min=0),
            dict(scans=300, keyframes=0, ate_rmse_m=33.2759, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759}, ate_m_by_lap={0: 33.2759}, lap_starts=[0],
                 lost_at=115, matches_min=0),
            dict(scans=400, keyframes=0, ate_rmse_m=52.4204, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759}, ate_m_by_lap={0: 52.4204}, lap_starts=[0],
                 lost_at=115, matches_min=0),
            dict(scans=500, keyframes=0, ate_rmse_m=58.4805, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759, 500: 58.4805}, ate_m_by_lap={0: 58.4805},
                 lap_starts=[0], lost_at=115, matches_min=0),
            dict(scans=600, keyframes=0, ate_rmse_m=58.2627, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759, 500: 58.4805}, ate_m_by_lap={0: 58.0728, 1:
                 None}, lap_starts=[0, 598], lost_at=115, matches_min=0),
            dict(scans=700, keyframes=0, ate_rmse_m=69.832, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759, 500: 58.4805}, ate_m_by_lap={0: 58.0728, 1:
                 24.1402}, lap_starts=[0, 598], lost_at=115, matches_min=0),
            dict(scans=800, keyframes=0, ate_rmse_m=70.609, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759, 500: 58.4805}, ate_m_by_lap={0: 58.0728, 1:
                 35.4442}, lap_starts=[0, 598], lost_at=115, matches_min=0),
            dict(scans=900, keyframes=0, ate_rmse_m=71.0395, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759, 500: 58.4805}, ate_m_by_lap={0: 58.0728, 1:
                 61.2514}, lap_starts=[0, 598], lost_at=115, matches_min=0),
            dict(scans=1000, keyframes=0, ate_rmse_m=72.3417, ate_m_of_first={100: 0.360583,
                 200: 7.35796, 300: 33.2759, 500: 58.4805}, ate_m_by_lap={0: 58.0728, 1:
                 66.8492}, lap_starts=[0, 598], lost_at=115, matches_min=0),
        ]),
    "backends": dict(chain_length=1000, end_drift_before_m=1.57282, loop={'i': 402, 'j': 999,
             'end_drift_after_m': 0.601476, 'moved_max_m': 1.02696, 'seconds': 52.645},
             gnss={'anchors_used': [0, 100, 200, 300, 400, 500, 600, 700],
             'end_drift_after_m': 1.73072, 'moved_max_m': 0.681755, 'seconds': 90.79})
}

# The port on the CPU: the second witness.
PORT_CPU_RECORD = {
    "slam": dict(scans=1000, keyframes=318, ate_rmse_m=0.475273, ate_m_of_first={100:
             0.065461, 200: 0.110039, 300: 0.111098, 500: 0.106294}, ate_m_by_lap={0:
             0.12736, 1: 0.128881}, lap_starts=[0, 598], end_drift_m=1.11987,
             lost_at=None, matches_min=71, matches_median=1196.0, voxels_last=[997, 1946,
             15499, 0], flat_voxels_max=19494, corner_voxels_max=2664, progress=[
            dict(scans=100, keyframes=32, ate_rmse_m=0.065461, ate_m_of_first={100:
                 0.065461}, ate_m_by_lap={0: 0.065461}, lap_starts=[0], lost_at=None,
                 matches_min=92),
            dict(scans=200, keyframes=64, ate_rmse_m=0.110039, ate_m_of_first={100: 0.065461,
                 200: 0.110039}, ate_m_by_lap={0: 0.110039}, lap_starts=[0], lost_at=None,
                 matches_min=92),
            dict(scans=300, keyframes=96, ate_rmse_m=0.111098, ate_m_of_first={100: 0.065461,
                 200: 0.110039, 300: 0.111098}, ate_m_by_lap={0: 0.111098}, lap_starts=[0],
                 lost_at=None, matches_min=92),
            dict(scans=400, keyframes=127, ate_rmse_m=0.10418, ate_m_of_first={100: 0.065461,
                 200: 0.110039, 300: 0.111098}, ate_m_by_lap={0: 0.10418}, lap_starts=[0],
                 lost_at=None, matches_min=92),
            dict(scans=500, keyframes=159, ate_rmse_m=0.106294, ate_m_of_first={100:
                 0.065461, 200: 0.110039, 300: 0.111098, 500: 0.106294}, ate_m_by_lap={0:
                 0.106294}, lap_starts=[0], lost_at=None, matches_min=92),
            dict(scans=600, keyframes=191, ate_rmse_m=0.127712, ate_m_of_first={100:
                 0.065461, 200: 0.110039, 300: 0.111098, 500: 0.106294}, ate_m_by_lap={0:
                 0.12736, 1: None}, lap_starts=[0, 598], lost_at=None, matches_min=92),
            dict(scans=700, keyframes=223, ate_rmse_m=0.171031, ate_m_of_first={100:
                 0.065461, 200: 0.110039, 300: 0.111098, 500: 0.106294}, ate_m_by_lap={0:
                 0.12736, 1: 0.119622}, lap_starts=[0, 598], lost_at=None, matches_min=71),
            dict(scans=800, keyframes=255, ate_rmse_m=0.262142, ate_m_of_first={100:
                 0.065461, 200: 0.110039, 300: 0.111098, 500: 0.106294}, ate_m_by_lap={0:
                 0.12736, 1: 0.118361}, lap_starts=[0, 598], lost_at=None, matches_min=71),
            dict(scans=900, keyframes=286, ate_rmse_m=0.394242, ate_m_of_first={100:
                 0.065461, 200: 0.110039, 300: 0.111098, 500: 0.106294}, ate_m_by_lap={0:
                 0.12736, 1: 0.122173}, lap_starts=[0, 598], lost_at=None, matches_min=71),
            dict(scans=1000, keyframes=318, ate_rmse_m=0.475273, ate_m_of_first={100:
                 0.065461, 200: 0.110039, 300: 0.111098, 500: 0.106294}, ate_m_by_lap={0:
                 0.12736, 1: 0.128881}, lap_starts=[0, 598], lost_at=None, matches_min=71),
        ]),
    "mapping": dict(scans=598, keyframes=191, ate_rmse_m=0.565514, ate_m_of_first={100:
             0.0660172, 200: 0.212629, 300: 0.340529, 500: 0.438591}, ate_m_by_lap={0:
             0.565514}, lap_starts=[0], end_drift_m=1.14733, lost_at=None,
             matches_min=77, matches_median=543.0, voxels_last=[595, 11494, 89174, 0],
             flat_voxels_max=89174, corner_voxels_max=11494, progress=[
            dict(scans=100, keyframes=32, ate_rmse_m=0.0660172, ate_m_of_first={100:
                 0.0660172}, ate_m_by_lap={0: 0.0660172}, lap_starts=[0], lost_at=None,
                 matches_min=92),
            dict(scans=200, keyframes=64, ate_rmse_m=0.212629, ate_m_of_first={100:
                 0.0660172, 200: 0.212629}, ate_m_by_lap={0: 0.212629}, lap_starts=[0],
                 lost_at=None, matches_min=90),
            dict(scans=300, keyframes=96, ate_rmse_m=0.340529, ate_m_of_first={100:
                 0.0660172, 200: 0.212629, 300: 0.340529}, ate_m_by_lap={0: 0.340529},
                 lap_starts=[0], lost_at=None, matches_min=77),
            dict(scans=400, keyframes=127, ate_rmse_m=0.421043, ate_m_of_first={100:
                 0.0660172, 200: 0.212629, 300: 0.340529}, ate_m_by_lap={0: 0.421043},
                 lap_starts=[0], lost_at=None, matches_min=77),
            dict(scans=500, keyframes=159, ate_rmse_m=0.438591, ate_m_of_first={100:
                 0.0660172, 200: 0.212629, 300: 0.340529, 500: 0.438591}, ate_m_by_lap={0:
                 0.438591}, lap_starts=[0], lost_at=None, matches_min=77),
        ]),
    "localization": dict(scans=1000, keyframes=0, ate_rmse_m=137.562, ate_m_of_first={100: 0.249854,
             200: 4.31424, 300: 17.6707, 500: 68.7498}, ate_m_by_lap={0: 99.6481, 1:
             48.1874}, lap_starts=[0, 598], end_drift_m=243.984, lost_at=117,
             matches_min=0, matches_median=0.0, voxels_last=None,
             prior_map={'corner_occupied': 11494, 'flat_occupied': 89174, 'clipped': 0,
             'corner_kept': 8192, 'flat_kept': 8192, 'capacity': 8192, 'corner_points':
             76085, 'flat_points': 391048}, mapping_scans=598, progress=[
            dict(scans=100, keyframes=0, ate_rmse_m=0.249854, ate_m_of_first={100: 0.249854},
                 ate_m_by_lap={0: 0.249854}, lap_starts=[0], lost_at=None, matches_min=30),
            dict(scans=200, keyframes=0, ate_rmse_m=4.31424, ate_m_of_first={100: 0.249854,
                 200: 4.31424}, ate_m_by_lap={0: 4.31424}, lap_starts=[0], lost_at=117,
                 matches_min=0),
            dict(scans=300, keyframes=0, ate_rmse_m=17.6707, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707}, ate_m_by_lap={0: 17.6707}, lap_starts=[0],
                 lost_at=117, matches_min=0),
            dict(scans=400, keyframes=0, ate_rmse_m=36.1517, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707}, ate_m_by_lap={0: 36.1517}, lap_starts=[0],
                 lost_at=117, matches_min=0),
            dict(scans=500, keyframes=0, ate_rmse_m=68.7498, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707, 500: 68.7498}, ate_m_by_lap={0: 68.7498},
                 lap_starts=[0], lost_at=117, matches_min=0),
            dict(scans=600, keyframes=0, ate_rmse_m=100.166, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707, 500: 68.7498}, ate_m_by_lap={0: 99.6481, 1:
                 None}, lap_starts=[0, 598], lost_at=117, matches_min=0),
            dict(scans=700, keyframes=0, ate_rmse_m=125.727, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707, 500: 68.7498}, ate_m_by_lap={0: 99.6481, 1:
                 8.03202}, lap_starts=[0, 598], lost_at=117, matches_min=0),
            dict(scans=800, keyframes=0, ate_rmse_m=139.54, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707, 500: 68.7498}, ate_m_by_lap={0: 99.6481, 1:
                 18.7454}, lap_starts=[0, 598], lost_at=117, matches_min=0),
            dict(scans=900, keyframes=0, ate_rmse_m=143.009, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707, 500: 68.7498}, ate_m_by_lap={0: 99.6481, 1:
                 47.608}, lap_starts=[0, 598], lost_at=117, matches_min=0),
            dict(scans=1000, keyframes=0, ate_rmse_m=137.562, ate_m_of_first={100: 0.249854,
                 200: 4.31424, 300: 17.6707, 500: 68.7498}, ate_m_by_lap={0: 99.6481, 1:
                 48.1874}, lap_starts=[0, 598], lost_at=117, matches_min=0),
        ]),
    "backends": dict(chain_length=1000, end_drift_before_m=1.11987, loop={'i': 402, 'j': 999,
             'end_drift_after_m': 0.451334, 'moved_max_m': 0.848894, 'seconds': 29.0496},
             gnss={'anchors_used': [0, 100, 200, 300, 400, 500, 600, 700],
             'end_drift_after_m': 1.46556, 'moved_max_m': 0.675699, 'seconds': 44.332})
}


def _within(got, ref, factor, floor) -> bool:
    return got is not None and got <= max(factor * ref, ref + floor)


def gates(result: dict, ref: dict, margins: dict = GATES) -> list:
    """What fails in `result` against the reference record `ref` at the same
    depth (two `result()` records or readings of the same scans); empty
    when every gate holds. Keyframes within `keyframes_tol`; each prefix's
    and each lap's ATE at most `factor` x the reference's (or its value +
    `floor`, whichever is larger), for the prefixes and laps that end
    before the scan where the reference lost the map (after it a pose is
    the constant-velocity guess); that scan (`lost_at`) the same, within
    `lost_scans`."""
    bad = []
    tol = margins["keyframes_tol"]
    if not abs(result["keyframes"] - ref["keyframes"]) <= tol * ref["keyframes"]:
        bad.append(f"keyframes {result['keyframes']} not within {tol:.0%} of the reference's "
                   f"{ref['keyframes']}")
    lost = ref["lost_at"] if ref["lost_at"] is not None else ref["scans"]
    starts = list(ref["lap_starts"]) + [ref["scans"]]
    for name, fac, floor, end in (
            ("ate_m_of_first", "prefix_ate_factor", "prefix_ate_floor_m", lambda k: k),
            ("ate_m_by_lap", "lap_ate_factor", "lap_ate_floor_m", lambda k: starts[k + 1])):
        got = {int(k): v for k, v in result[name].items()}  # JSON keys are text
        for k, r in ref[name].items():
            if r is None or end(int(k)) > lost:
                continue
            if not _within(got.get(int(k)), r, margins[fac], margins[floor]):
                bad.append(f"{name}[{k}] {got.get(int(k))} m > max({margins[fac]} x, "
                           f"+{margins[floor]} m) the reference's {r} m")
    a, b = result["lost_at"], ref["lost_at"]
    if (a is None) != (b is None) or (a is not None and abs(a - b) > margins["lost_scans"]):
        bad.append(f"lost at scan {a}, the reference at {b}")
    return bad


GATED = ("scans", "keyframes", "ate_rmse_m", "ate_m_of_first", "ate_m_by_lap", "lap_starts",
         "end_drift_m", "lost_at", "matches_min", "matches_median", "voxels_last")
READING = ("scans", "keyframes", "ate_rmse_m", "ate_m_of_first", "ate_m_by_lap", "lap_starts",
           "lost_at", "matches_min")


def gated_fields(record: dict) -> dict:
    """A run's record cut to what the gates and the phase's lines read, its
    readings too (how `JAX_RECORD` was made from the script's records)."""
    out = {k: record[k] for k in GATED if k in record}
    out["progress"] = [{k: r[k] for k in READING} for r in record.get("progress", ())]
    # The scan where the map is lost, at LOST_MATCHES (a record made with
    # another threshold reads the same from its per-scan associations).
    out["lost_at"] = lost_scan(record["matches"])
    for r in out["progress"]:
        r["lost_at"] = lost_scan(record["matches"], r["scans"])
    for k in ("prior_map", "mapping_scans"):
        if k in record:
            out[k] = record[k]
    if record.get("voxels"):
        out["flat_voxels_max"] = max(v[2] for v in record["voxels"])
        out["corner_voxels_max"] = max(v[1] for v in record["voxels"])
    return out


def at_depth(record: dict, scans: int) -> dict:
    """A whole run's record cut to its reading at `scans` (a multiple of its
    progress interval): what a run of that depth is held against. Raises
    ValueError where the record holds no reading there."""
    return soak.at_depth(record, scans, "scans", "scans")
