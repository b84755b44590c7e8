"""The LiDAR soak's pieces on the CPU (`eval/lidar_soak.py`,
`scripts/lidar_soak_reference.py`, the scans-only write of
`eval/kitti_synth.py`), and LiDAR-only odometry of the port against the JAX
package past the local map's capacity.

- The scans-only write: its scans, calib, times and poses are the bytes of
  the full write's (images too); a scan's bytes do not depend on the
  sequence's length; `first_frame` writes the rest of a shorter write.
- The record's gates (`lidar_soak.gates`, `at_depth`) at every depth the
  JAX package's record (`lidar_soak.JAX_RECORD`) holds, and a refusal at
  one it lacks; each gate named when a changed run breaks it.
- `voxel_downsample` and `_voxel_downsample_payload` bitwise against the
  JAX package on a cloud of more occupied voxels than the capacity (with
  points past the key's +-204.8 m), the x-major cut it makes, and
  `lidar_soak.occupied_voxels` (numpy and torch) against what it keeps.
- Both packages' `LidarOdometry` over the first `SCANS` scans of the
  sequence (the window's flat voxels pass the map's 8,192 from keyframe
  ~11 on): slam mode, then mapping mode, then localization against the
  mapping run's map. Keyframe scans equal; poses within `POSE_TOL_M` /
  `ROT_TOL`; the window's occupied voxels within `VOXEL_TOL` at every
  keyframe; the local map's kept voxels equal.
- `backend_for_loop` and `backend_for_gnss` over a 200-pose chain of the
  JAX package's own run of the sequence (`lidar_soak_jax.npz`): the
  chains within `BACKEND_TOL_M`.
- The reference script through the port over a short sequence.
"""

import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.lidar import odometry as j_odo
from sqrtlm_slam_tpu.lidar import voxel_map as j_vmap
from sqrtlm_slam_tpu.utils import kitti_sequence_config as j_kitti_config
from sqrtlm_slam_tpu_torch.eval import kitti_synth, lidar_soak, planeworld
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.lidar import odometry as t_odo
from sqrtlm_slam_tpu_torch.lidar import voxel_map as t_vmap
from sqrtlm_slam_tpu_torch.utils.config import kitti_sequence_config as t_kitti_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS = 60
# Float32 Gauss-Newton with other summation orders, over 60 scans through a
# truncated map. Measured (this test's runs on one CPU): positions within
# 7.7 mm (slam, mapping; a one-scan spike at scan 56, 1 mm elsewhere) and
# 8.7 mm (localization), rotations 8.0e-4; the occupied voxels within
# 0.17 % (flat: 11,409 against 11,405 at the last keyframe). The bars are
# ~2.5 x those.
POSE_TOL_M = 0.02
ROT_TOL = 2e-3
VOXEL_TOL = 0.005  # occupied voxels, relative: points near a cell's face
# The backends over 200 poses: the two packages' chains 9.9e-5 m apart
# (loop) and 8.7e-5 m (gnss), after moving them up to 0.19 m.
BACKEND_TOL_M = 5e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lidar_soak") / "seq")
    kitti_synth.generate(root, n_frames=SCANS, workers=3, centred=True, scans_only=True,
                         log=lambda *a: None)
    return root


# -- the writer -----------------------------------------------------------------

def test_scans_only_write_is_the_full_writes_bytes(tmp_path):
    full, scans, head = (str(tmp_path / n) for n in ("full", "scans", "head"))
    kitti_synth.generate(full, n_frames=4, centred=True, log=lambda *a: None)
    kitti_synth.generate(head, n_frames=2, centred=True, scans_only=True, log=lambda *a: None)
    # The rest of a shorter write: its scans linked in, frames 2-3 written.
    os.makedirs(os.path.join(scans, "sequences", "00", "velodyne"))
    for i in range(2):
        name = os.path.join("sequences", "00", "velodyne", f"{i:06d}.bin")
        os.link(os.path.join(head, name), os.path.join(scans, name))
    kitti_synth.generate(scans, n_frames=4, centred=True, scans_only=True, first_frame=2,
                         workers=2, log=lambda *a: None)
    assert not os.path.exists(os.path.join(scans, "sequences", "00", "image_0"))
    names = [os.path.join("poses", "00.txt")] + [
        os.path.join("sequences", "00", n) for n in ("calib.txt", "times.txt")] + [
        os.path.join("sequences", "00", "velodyne", f"{i:06d}.bin") for i in range(4)]
    for n in names:
        assert filecmp.cmp(os.path.join(full, n), os.path.join(scans, n), shallow=False), n
    assert sorted(os.listdir(os.path.join(scans, "sequences", "00", "velodyne"))) == [
        f"{i:06d}.bin" for i in range(4)]
    assert lidar_soak.scan_digest(full, 4) == lidar_soak.scan_digest(scans, 4)
    assert lidar_soak.scan_digest(full, 2) == lidar_soak.scan_digest(head, 2)


# -- the record and its gates ------------------------------------------------------

def _depths(record):
    return [r["scans"] for r in record["progress"]] + [record["scans"]]


@pytest.mark.parametrize("run", ["slam", "mapping", "localization"])
def test_gates_hold_the_record_against_itself_at_every_depth(run):
    rec = lidar_soak.JAX_RECORD[run]
    for depth in _depths(rec):
        at = lidar_soak.at_depth(rec, depth)
        assert at["scans"] == depth
        assert lidar_soak.gates(at, at) == []
        # Through JSON, as a run's record comes back from a log line.
        assert lidar_soak.gates(json.loads(json.dumps(at)), at) == []
    for depth in (150, rec["scans"] + 100, 0):
        with pytest.raises(ValueError):
            lidar_soak.at_depth(rec, depth)


def test_gates_name_what_a_changed_run_breaks():
    ref = lidar_soak.JAX_RECORD["slam"]
    g = lidar_soak.GATES
    worse = dict(ref, keyframes=int(ref["keyframes"] * (1 + 2 * g["keyframes_tol"])) + 1)
    assert [f for f in lidar_soak.gates(worse, ref) if f.startswith("keyframes")]
    k, v = next(iter(ref["ate_m_of_first"].items()))
    far = max(g["prefix_ate_factor"] * v, v + g["prefix_ate_floor_m"]) * 1.01
    worse = dict(ref, ate_m_of_first={**ref["ate_m_of_first"], k: far})
    assert [f for f in lidar_soak.gates(worse, ref) if f.startswith("ate_m_of_first")]
    lap = dict(ref["ate_m_by_lap"])
    lap[next(iter(lap))] = 100.0
    assert [f for f in lidar_soak.gates(dict(ref, ate_m_by_lap=lap), ref)
            if f.startswith("ate_m_by_lap")]
    lost = dict(ref, lost_at=(ref["lost_at"] or 0) + g["lost_scans"] + 7)
    assert [f for f in lidar_soak.gates(lost, ref) if f.startswith("lost at")]
    within = dict(ref, keyframes=ref["keyframes"] + int(g["keyframes_tol"] * ref["keyframes"]))
    assert lidar_soak.gates(within, ref) == []


def test_mapping_gates_take_the_rounding_spread_and_no_more():
    """The mapping run is held at MAPPING_GATES: its lap at most 3 x the JAX
    run's (the largest of the CPU runs' rounding-level draws, 1.141 m, is
    2.92 x), its prefixes 2.5 x. A lap past that fails, and so does a run
    that drew the slam margins' 2 x."""
    ref = lidar_soak.JAX_RECORD["mapping"]
    g = lidar_soak.MAPPING_GATES
    lap = ref["ate_m_by_lap"][0]
    draw = dict(ref, ate_m_by_lap={0: 1.141})  # the port on the CPU, --jitter-ulps 3
    assert lidar_soak.gates(draw, ref, g) == []
    assert [f for f in lidar_soak.gates(draw, ref) if f.startswith("ate_m_by_lap[0]")]
    past = dict(ref, ate_m_by_lap={0: g["lap_ate_factor"] * lap * 1.01})
    assert [f for f in lidar_soak.gates(past, ref, g) if f.startswith("ate_m_by_lap[0]")]
    k, v = 300, ref["ate_m_of_first"][300]
    far = dict(ref, ate_m_of_first={**ref["ate_m_of_first"], k: g["prefix_ate_factor"] * v * 1.01})
    assert [f for f in lidar_soak.gates(far, ref, g) if f.startswith("ate_m_of_first[300]")]


# -- the capacity cut ----------------------------------------------------------------

def _crowded_cloud(n=40000, seed=0):
    """More occupied 0.4 m voxels than the map's 8,192: a street-sized
    slab, a few points past the key's +-204.8 m, some invalid."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * [160.0, 120.0, 6.0] - [80.0, 60.0, 2.0]).astype(np.float32)
    pts[:40, 0] += 300.0  # clamped by the key
    valid = rng.rand(n) > 0.05
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, valid, normals


@pytest.mark.parametrize("capacity", [8192, 1000])
def test_voxel_downsample_past_the_capacity_is_bitwise_the_jax_packages(capacity):
    pts, valid, normals = _crowded_cloud()
    occupied, clipped = lidar_soak.occupied_voxels(pts, valid, 0.4)
    assert occupied > capacity and clipped > 0
    o_j, v_j = j_vmap.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), 0.4, capacity)
    o_t, v_t = t_vmap.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(valid), 0.4,
                                       capacity)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    assert int(v_t.sum()) == capacity
    stacked = np.concatenate([pts, normals], 1)
    p_j, pv_j = j_odo._voxel_downsample_payload(jnp.asarray(stacked), jnp.asarray(valid), 0.4,
                                                capacity)
    p_t, pv_t = t_odo._voxel_downsample_payload(torch.as_tensor(stacked),
                                                torch.as_tensor(valid), 0.4, capacity)
    np.testing.assert_array_equal(pv_t.numpy(), np.asarray(pv_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    # The key is x-major: the cut keeps the voxels of smallest x, not those
    # nearest the sensor (the origin): every kept point lies at a smaller x
    # cell than every point of a dropped voxel.
    cell = np.floor(pts / np.float32(0.4)).astype(np.int64)
    kept = {tuple(c) for c in np.floor(o_t.numpy()[v_t.numpy()] / np.float32(0.4)).astype(
        np.int64)}
    dropped_x = [c[0] for c, ok in zip(map(tuple, cell), valid) if ok and c not in kept]
    assert max(c[0] for c in kept) <= min(dropped_x)
    assert min(np.abs(pts[valid]).sum(1)) < min(np.abs(o_t.numpy()[v_t.numpy()]).sum(1))


def test_occupied_voxels_count_what_the_downsample_keeps_under_the_capacity():
    pts, valid, _ = _crowded_cloud(n=3000, seed=1)
    n_np, c_np = lidar_soak.occupied_voxels(pts, valid, 0.4)
    n_t, c_t = lidar_soak.occupied_voxels(torch.as_tensor(pts), torch.as_tensor(valid), 0.4)
    assert (n_np, c_np) == (int(n_t), int(c_t))
    _, ok = t_vmap.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(valid), 0.4, 4096)
    assert n_np == int(ok.sum()) < 4096


# -- both packages over the sequence ----------------------------------------------

class _Runs:
    """A package's slam, mapping and localization runs over the scans."""

    def __init__(self, name, root):
        self.name = name
        gt_l = lidar_soak.lidar_gt(root)
        if name == "jax":
            cls, mod, host = j_odo.LidarOdometry, j_odo, np.asarray
            make = lambda: cls(j_odo.OdomConfig(), j_kitti_config("00").lidar)  # noqa: E731
            points = jnp.asarray
        else:
            cls, mod = t_odo.LidarOdometry, t_odo
            host = lambda x: x.numpy() if torch.is_tensor(x) else x  # noqa: E731
            make = lambda: cls(feat_cfg=t_kitti_config("00").lidar, device="cpu")  # noqa: E731
            points = lambda p: p  # noqa: E731
        scans = [lidar_soak.scan(root, i) for i in range(SCANS)]
        self.records = {}
        for mode in ("slam", "mapping"):
            odo = make()
            odo.mode = mode
            with lidar_soak.Recorder(cls, mod, gt_l, host, every=SCANS, log=lambda s: None,
                                     record_chain=mode == "slam") as rec:
                for p in scans:
                    odo.process(points(p))
            self.records[mode] = (rec.result(), rec.poses_lw())
            self.kept = [int(np.asarray(host(m.valid)).sum()) for m in odo._local_map[:2]]
        self.chain = odo
        self.prior = lidar_soak.prior_map(odo, host)
        loc = make()
        loc.set_prior_map(**self.prior)
        self.prior_voxels = lidar_soak.prior_map_voxels(self.prior, loc._local_map, loc.cfg,
                                                        host)
        with lidar_soak.Recorder(cls, mod, gt_l, host, every=SCANS, log=lambda s: None) as rec:
            for p in scans:
                loc.process(points(p))
        self.records["localization"] = (rec.result(), rec.poses_lw())


@pytest.fixture(scope="module")
def both(sequence):
    return {n: _Runs(n, sequence) for n in ("jax", "port")}


def _close(a, b):
    assert np.abs(a[:, :, 3] - b[:, :, 3]).max() < POSE_TOL_M
    assert np.abs(a[:, :, :3] - b[:, :, :3]).max() < ROT_TOL


@pytest.mark.parametrize("mode", ["slam", "mapping", "localization"])
def test_lidar_odometry_over_the_sequence_matches_the_jax_package(both, mode):
    (rj, pj), (rt, pt) = both["jax"].records[mode], both["port"].records[mode]
    assert rt["scans"] == rj["scans"] == SCANS
    assert rt["keyframe_scans"] == rj["keyframe_scans"]
    _close(pt, pj)
    assert abs(rt["ate_rmse_m"] - rj["ate_rmse_m"]) < POSE_TOL_M
    assert rt["lost_at"] == rj["lost_at"]
    if mode != "localization":
        assert [v[0] for v in rt["voxels"]] == rj["keyframe_scans"]
        for vt, vj in zip(rt["voxels"], rj["voxels"]):
            for a, b in zip(vt[1:3], vj[1:3]):
                assert abs(a - b) <= VOXEL_TOL * b, (vt, vj)
        # Past the capacity from about keyframe 11 on, in both packages.
        flat = [v[2] for v in rj["voxels"]]
        assert max(flat) > t_odo.OdomConfig().map_capacity


def test_the_local_maps_keep_the_same_voxels(both):
    j, t = both["jax"], both["port"]
    assert t.kept == j.kept
    assert j.kept[1] == t_odo.OdomConfig().map_capacity  # flat: cut at the capacity
    for k in ("corner_kept", "flat_kept", "capacity"):
        assert t.prior_voxels[k] == j.prior_voxels[k], k
    for k in ("corner_occupied", "flat_occupied"):
        assert abs(t.prior_voxels[k] - j.prior_voxels[k]) <= VOXEL_TOL * j.prior_voxels[k]


# -- the backends --------------------------------------------------------------------

def _lidar_gt(n):
    """`lidar_soak.lidar_gt` of the sequence's first n scans, from the
    writer's trajectory and `Tr` (no files)."""
    poses, _ = planeworld.circuit_trajectory(n, step=0.8)
    T_cv = planeworld.center_scan_on_columns(np.zeros((0, 3)), planeworld.T_CAM_VELO)[1]
    T_wl = np.stack([np.linalg.inv(lidar_soak.to_matrix(np.asarray(T.R, np.float64),
                                                        np.asarray(T.t, np.float64)))
                     for T in poses]) @ T_cv
    return np.linalg.inv(T_wl[0]) @ T_wl


def test_backends_over_a_200_pose_chain_match_the_jax_package():
    data = np.load(os.path.join(os.path.dirname(lidar_soak.__file__), "lidar_soak_jax.npz"))
    chain = data["slam"][:200].astype(np.float32)
    gt_l = _lidar_gt(200)
    last = len(chain) - 1
    T = lidar_soak.relative(gt_l, 0, last)
    anchors = lidar_soak.gnss_anchors(gt_l, len(chain), every=25)
    j = j_odo.LidarOdometry()
    t = t_odo.LidarOdometry(device="cpu")
    j._chain = [j_se3.SE3(jnp.asarray(M[:, :3]), jnp.asarray(M[:, 3])) for M in chain]
    t._chain = [t_se3.SE3(torch.as_tensor(M[:, :3]), torch.as_tensor(M[:, 3])) for M in chain]
    kept_j, kept_t = list(j._chain), list(t._chain)
    f32 = np.float32
    for call in (
            lambda o, se3, arr: o.backend_for_loop(0, last, se3.SE3(arr(T[:3, :3].astype(f32)),
                                                                    arr(T[:3, 3].astype(f32)))),
            lambda o, se3, arr: o.backend_for_gnss(anchors)):
        j._chain, t._chain = list(kept_j), list(kept_t)
        got_j = lidar_soak.chain_matrices(call(j, j_se3, jnp.asarray), np.asarray)
        got_t = lidar_soak.chain_matrices(call(t, t_se3, torch.as_tensor), lambda x: x.numpy())
        moved = np.abs(lidar_soak.chain_positions(got_j)
                       - lidar_soak.chain_positions(chain.astype(float))).max()
        assert moved > 100 * BACKEND_TOL_M  # the backend did move the chain
        assert np.abs(lidar_soak.chain_positions(got_t)
                      - lidar_soak.chain_positions(got_j)).max() < BACKEND_TOL_M
        assert lidar_soak.end_drift(got_t, gt_l) < lidar_soak.end_drift(chain.astype(float),
                                                                         gt_l)


# -- the reference script ------------------------------------------------------------

def test_reference_script_through_the_port(sequence, tmp_path):
    record, poses = str(tmp_path / "rec.json"), str(tmp_path / "poses.npz")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "lidar_soak_reference.py"),
         "--package", "port", "--root", sequence, "--scans", "8", "--mapping-scans", "6",
         "--every", "4", "--record", record, "--poses", poses],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = [json.loads(ln[len("RESULT "):]) for ln in out.stdout.splitlines()
           if ln.startswith("RESULT ")]
    assert [r["run"] for r in res] == ["slam", "backends", "mapping", "localization"]
    slam, backends, mapping, loc = res
    assert slam["scans"] == loc["scans"] == 8 and mapping["scans"] == 6
    assert [p["scans"] for p in slam["progress"]] == [4, 8]
    assert slam["runner"]["mode"] == "lidar" and slam["runner"]["frames"] == 8
    assert slam["scan_digest"] == lidar_soak.scan_digest(sequence, 8)
    assert slam["keyframe_scans"][0] == 0 and slam["voxels"][0][0] == 0
    assert backends["chain_length"] == 8 and len(backends["gnss"]["anchors"]) == 1
    assert loc["prior_map"]["capacity"] == 8192 and loc["keyframes"] == 0
    with open(record) as f:
        assert set(json.load(f)) == {"slam", "backends", "mapping", "localization"}
    # What the module's records keep of a RESULT, and the gates over it.
    gated = lidar_soak.gated_fields(slam)
    assert set(lidar_soak.GATED) <= set(gated) and len(gated["progress"]) == 2
    assert lidar_soak.gates(gated, gated) == []
    assert lidar_soak.at_depth(gated, 4)["scans"] == 4
    arrays = np.load(poses)
    assert arrays["slam"].shape == (8, 3, 4) and arrays["backend_loop"].shape == (8, 3, 4)


def test_the_record_module_imports_neither_jax_nor_torch():
    code = ("import sys; sys.path.insert(0, %r); "
            "from sqrtlm_slam_tpu_torch.eval import lidar_soak; "
            "assert not {'jax', 'torch'} & set(sys.modules), sorted(sys.modules)" % REPO)
    spec = importlib.util.find_spec("sqrtlm_slam_tpu_torch.eval.lidar_soak")
    assert spec is not None
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
