"""Camera+LiDAR fusion of the port against the JAX package, module by module
and as a whole.

LiDAR modules: one noisy `planeworld.lidar_scan` of a small street (16 rings
x 360 rays, yawed to the column centres, with a matching `LidarConfig`) goes
through every stage of `lidar/features.py` in both packages; random clouds
through `lidar/voxel_map.py`; random poses through `factors/lidar.py`; the
problem of tests/test_pose_opt.py (made with numpy here) through
`_lidar_system` and `optimize_pose(lidar_obs=...)`.

The slice as a whole: the JAX system tracks three fusion frames of
tests/test_e2e_fusion.py's scene (a keyframe each, local mapping left out);
its state at the fourth frame crosses through `convert`, and both packages
run the fused stage, the fused `track_frame_step` and `_lidar_stage` on
identical inputs. A port-only `track_fusion` run holds the e2e bars; the run
through both packages is `slow`.

Tolerances are stated in each test.
"""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import planeworld as j_planeworld
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu.factors import lidar as j_lf
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.lidar import features as j_feat
from sqrtlm_slam_tpu.lidar import odometry as j_odo
from sqrtlm_slam_tpu.lidar import voxel_map as j_vmap
from sqrtlm_slam_tpu.optim import pose_opt as j_pose_opt
from sqrtlm_slam_tpu.pipeline import SlamSystem, SystemConfig, TrackingConfig
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu.pipeline import local_mapping as j_local_mapping
from sqrtlm_slam_tpu.pipeline import tracking as j_tracking
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import planeworld as t_planeworld
from sqrtlm_slam_tpu_torch.eval import synthetic as t_synthetic
from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.factors import lidar as t_lf
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.lidar import features as t_feat
from sqrtlm_slam_tpu_torch.lidar import odometry as t_odo
from sqrtlm_slam_tpu_torch.lidar import voxel_map as t_vmap
from sqrtlm_slam_tpu_torch.optim import pose_opt as t_pose_opt
from sqrtlm_slam_tpu_torch.pipeline import frame as t_frame
from sqrtlm_slam_tpu_torch.pipeline import local_mapping as t_local_mapping
from sqrtlm_slam_tpu_torch.pipeline import system as t_system
from sqrtlm_slam_tpu_torch.pipeline import tracking as t_tracking


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One CPU thread: in some processes of the CPU test machine the second
    OpenMP thread's `torch.sqrt` errs by up to 3e-4 relative, and ranges
    are compared here at 1e-6 (ROADMAP queue 3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ----------------------------------------------------------------------
# planeworld: the numpy copy against the JAX package's
# ----------------------------------------------------------------------

SMALL_STREET = dict(seed=0, A=12.0, B=8.0, half_width=4.0, texel=0.05, panel_spacing=6.0)
SMALL_CFG = dict(num_rings=16, horizon_res_deg=1.0)


@pytest.fixture(scope="module")
def street():
    world_j = j_planeworld.street_circuit_world(**SMALL_STREET)
    world_t = t_planeworld.street_circuit_world(**SMALL_STREET)
    poses_j, perim_j = j_planeworld.circuit_trajectory(30, A=12.0, B=8.0, corner_r=3.0, step=0.5)
    poses_t, perim_t = t_planeworld.circuit_trajectory(30, A=12.0, B=8.0, corner_r=3.0, step=0.5)
    return world_j, world_t, poses_j, poses_t, perim_j, perim_t


def test_planeworld_copy_is_bit_identical(street):
    world_j, world_t, poses_j, poses_t, perim_j, perim_t = street
    assert perim_j == perim_t and len(world_j.planes) == len(world_t.planes)
    for a, b in zip(poses_j, poses_t):
        np.testing.assert_array_equal(np.asarray(a.R), b.R)
        np.testing.assert_array_equal(np.asarray(a.t), b.t)
    np.testing.assert_array_equal(j_planeworld.T_CAM_VELO, t_planeworld.T_CAM_VELO)
    for i in (0, 14, 29):  # a straight, a corner, the next straight
        img_j, depth_j = world_j.render(poses_j[i], DEFAULT_CAM, H=64, W=208, noise_seed=i)
        img_t, depth_t = world_t.render(poses_t[i], t_synthetic.DEFAULT_CAM, H=64, W=208,
                                        noise_seed=i)
        assert isinstance(img_t, np.ndarray) and img_t.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(img_j), img_t)
        np.testing.assert_array_equal(np.asarray(depth_j), depth_t)
        scan_j = world_j.lidar_scan(poses_j[i], j_planeworld.T_CAM_VELO, n_rings=16,
                                    n_azimuth=360, noise_seed=i)
        scan_t = world_t.lidar_scan(poses_t[i], t_planeworld.T_CAM_VELO, n_rings=16,
                                    n_azimuth=360, noise_seed=i)
        np.testing.assert_array_equal(scan_j, scan_t)
        assert scan_t.shape[1] == 4 and scan_t.shape[0] > 3000


# ----------------------------------------------------------------------
# lidar/features.py
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan(street):
    """One noisy 16 x 360 scan of the small street, its rays at the centres
    of the 1-degree columns, with a few NaN rows (inert in both packages)."""
    _, world_t, _, poses_t, _, _ = street
    raw = world_t.lidar_scan(poses_t[3], t_planeworld.T_CAM_VELO, n_rings=16, n_azimuth=360,
                             noise_seed=3)
    pts, _ = t_planeworld.center_scan_on_columns(raw, t_planeworld.T_CAM_VELO, 1.0)
    pts = np.concatenate([pts, np.full((7, 3), np.nan, np.float32)])
    return pts, j_feat.LidarConfig(**SMALL_CFG), t_feat.LidarConfig(**SMALL_CFG)


def test_lidar_config_defaults_match():
    assert t_feat.LidarConfig()._asdict() == j_feat.LidarConfig()._asdict()
    assert t_feat.LidarConfig().num_cols == 1800
    assert t_odo.OdomConfig()._asdict() == j_odo.OdomConfig()._asdict()
    assert convert.lidar_config(j_feat.LidarConfig(**SMALL_CFG)) == t_feat.LidarConfig(**SMALL_CFG)


def test_ring_and_azimuth_matches(scan):
    """Ring, column and keep exact where kept; range to 1e-6 relative."""
    pts, cfg_j, cfg_t = scan
    ring_j, col_j, rng_j, keep_j = (np.asarray(a) for a in j_feat.ring_and_azimuth(
        jnp.asarray(pts), cfg_j))
    ring_t, col_t, rng_t, keep_t = (a.numpy() for a in t_feat.ring_and_azimuth(T(pts), cfg_t))
    np.testing.assert_array_equal(keep_t, keep_j)
    assert keep_j.sum() > 3000 and not keep_j[-7:].any()
    np.testing.assert_array_equal(ring_t[keep_j], ring_j[keep_j])
    np.testing.assert_array_equal(col_t[keep_j], col_j[keep_j])
    np.testing.assert_allclose(rng_t[keep_j], rng_j[keep_j], rtol=1e-6)


def _range_images(scan):
    pts, cfg_j, cfg_t = scan
    return j_feat.build_range_image(jnp.asarray(pts), cfg_j), t_feat.build_range_image(T(pts),
                                                                                       cfg_t)


def test_build_range_image_matches(scan):
    """Depth exact (to float32 rounding of the square root), valid and ground
    exact; xyz equal where the cell has one candidate point."""
    pts, cfg_j, cfg_t = scan
    img_j, img_t = _range_images(scan)
    np.testing.assert_array_equal(img_t.valid.numpy(), np.asarray(img_j.valid))
    np.testing.assert_allclose(img_t.depth.numpy(), np.asarray(img_j.depth), rtol=1e-6)
    ring, col, _, keep = (a.numpy() for a in t_feat.ring_and_azimuth(T(pts), cfg_t))
    count = np.zeros((cfg_t.num_rings, cfg_t.num_cols), int)
    np.add.at(count, (ring[keep], col[keep]), 1)
    single = count == 1
    assert single.sum() > 3000
    np.testing.assert_array_equal(img_t.xyz.numpy()[single], np.asarray(img_j.xyz)[single])
    np.testing.assert_array_equal(img_t.ground.numpy()[single], np.asarray(img_j.ground)[single])
    # Empty cells hold zeros in both.
    assert not img_t.xyz.numpy()[~img_t.valid.numpy()].any()


def test_range_image_winner_is_the_latest_of_the_nearest():
    """Two points of one cell at the same range: the later one is the cell's
    point, whatever order a device writes in."""
    cfg = t_feat.LidarConfig(**SMALL_CFG)
    a = np.array([10.0, 0.05, -0.5], np.float32)
    b = np.array([10.0, 0.06, -0.5], np.float32)
    b *= np.linalg.norm(a) / np.linalg.norm(b)
    far = a * 1.5
    for first, second in ((a, b), (b, a)):
        img = t_feat.build_range_image(T(np.stack([far, first, second, far])), cfg)
        assert int(img.valid.sum()) == 1
        cell = img.xyz[img.valid][0].numpy()
        np.testing.assert_array_equal(cell, second)


def test_segmentation_matches(scan):
    """Labels and the segment validity mask are integer-exact."""
    _, cfg_j, cfg_t = scan
    img_j, img_t = _range_images(scan)
    # Feed the port the JAX depth, so a last-bit depth difference cannot move
    # an angle across the threshold.
    img_t = img_t._replace(depth=T(img_j.depth))
    lab_j = j_feat.segment_labels(img_j, cfg_j)
    lab_t = t_feat.segment_labels(img_t, cfg_t)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    assert len(np.unique(np.asarray(lab_j))) > 3
    np.testing.assert_array_equal(t_feat.segment_valid_mask(lab_t, cfg_t).numpy(),
                                  np.asarray(j_feat.segment_valid_mask(lab_j, cfg_j)))


def test_curvature_and_plane_fit_match(scan):
    """Curvature to 1e-5. Plane normals where the fit is valid in both: 95%
    of the cells to 1e-4, all to 1e-3, offsets to 1e-3 relative. The normal
    equations of points ~10 m from the sensor are badly conditioned (cond
    ~1e5-1e6): the JAX package solves them in float32 (LU), the port sums
    and solves them in float64 (closed-form Cholesky), so the difference is
    the float32 solution's own error, above 1e-4 on a few percent of the
    cells. The validity masks may differ on cells within 1% of the residual
    threshold."""
    _, cfg_j, cfg_t = scan
    img_j, img_t = _range_images(scan)
    img_t = img_t._replace(depth=T(img_j.depth), xyz=T(img_j.xyz))
    c_j = np.asarray(j_feat.curvature(img_j, cfg_j))
    c_t = t_feat.curvature(img_t, cfg_t).numpy()
    np.testing.assert_allclose(c_t, c_j, atol=1e-5, rtol=1e-5)
    assert (c_j >= 0).sum() > 2000 and (c_j > cfg_j.corner_thresh).sum() > 10
    n_j, d_j, ok_j = (np.asarray(a) for a in j_feat._neighborhood_plane_fit(img_j, cfg_j))
    n_t, d_t, ok_t = (a.numpy() for a in t_feat._neighborhood_plane_fit(img_t, cfg_t))
    assert ok_j.sum() > 500
    assert (ok_t != ok_j).sum() <= 0.01 * ok_j.sum()
    both = ok_j & ok_t
    diff = np.abs(n_t[both] - n_j[both]).max(-1)
    assert diff.max() < 1e-3 and (diff < 1e-4).mean() > 0.95, (diff.max(), (diff < 1e-4).mean())
    np.testing.assert_allclose(d_t[both], d_j[both], rtol=1e-3)


def _assert_features_equal(f_t, f_j, normal_atol=1e-3):
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        v_j = np.asarray(getattr(f_j, name + "_valid"))
        v_t = getattr(f_t, name + "_valid").numpy()
        np.testing.assert_array_equal(v_t, v_j, err_msg=name)
        np.testing.assert_array_equal(getattr(f_t, name).numpy()[v_j],
                                      np.asarray(getattr(f_j, name))[v_j], err_msg=name)
    v = np.asarray(f_j.flat_valid)
    np.testing.assert_allclose(f_t.flat_normal.numpy()[v], np.asarray(f_j.flat_normal)[v],
                               atol=normal_atol)
    np.testing.assert_allclose(f_t.flat_d.numpy()[v], np.asarray(f_j.flat_d)[v], rtol=1e-3,
                               atol=1e-3)


def test_extract_features_matches(scan):
    """The same cells are picked, in the same order: feature points equal
    bit for bit where valid (they are gathered scan points), masks equal,
    flat normals to 1e-3 (see the plane-fit test)."""
    pts, cfg_j, cfg_t = scan
    f_j = j_feat.extract_features(jnp.asarray(pts), cfg_j)
    f_t = t_feat.extract_features(T(pts), cfg_t)
    counts = {k: int(np.asarray(getattr(f_j, k)).sum()) for k in f_j._fields if "valid" in k}
    assert counts["sharp_valid"] > 5 and counts["flat_valid"] > 50, counts
    _assert_features_equal(f_t, f_j)
    # Without the NaN rows: the same features (they are inert).
    f_clean = t_feat.extract_features(T(pts[:-7]), cfg_t)
    for a, b in zip(f_clean, f_t):
        assert torch.equal(a, b)
    # transform_features: points, normals and offsets to 1e-5.
    R = np.asarray(j_planeworld.R_CAM_VELO, np.float32)
    t = np.array([0.0, -0.08, -0.27], np.float32)
    g_j = j_feat.transform_features(f_j, jnp.asarray(R), jnp.asarray(t))
    g_t = t_feat.transform_features(convert.lidar_features(f_j), T(R), T(t))
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_fewer_rays_than_columns_yield_no_feature_in_either_package(street):
    """Four rays per five columns (the default scanner's 1440 rays on the
    default 1800-column range image): every fifth column is empty, no
    curvature window is complete, and neither package extracts a feature."""
    _, world_t, _, poses_t, _, _ = street
    raw = world_t.lidar_scan(poses_t[3], t_planeworld.T_CAM_VELO, n_rings=16, n_azimuth=288,
                             noise_seed=3)[:, :3]
    f_j = j_feat.extract_features(jnp.asarray(raw), j_feat.LidarConfig(**SMALL_CFG))
    f_t = t_feat.extract_features(T(raw), t_feat.LidarConfig(**SMALL_CFG))
    for name in ("sharp_valid", "less_sharp_valid", "flat_valid", "less_flat_valid"):
        assert int(np.asarray(getattr(f_j, name)).sum()) == 0, name
        assert int(getattr(f_t, name).sum()) == 0, name


def test_topk_ties_take_the_lowest_column():
    """A noise-free plane gives many cells of curvature exactly 0: both
    packages pick the lowest columns of each subregion."""
    cfg_j, cfg_t = j_feat.LidarConfig(**SMALL_CFG), t_feat.LidarConfig(**SMALL_CFG)
    vals = np.zeros((16, 360), np.float32)
    vals[:, ::7] = 1.0
    mask = np.ones((16, 360), bool)
    mask[:, 5:9] = False
    for largest in (True, False):
        idx_j, ok_j = j_feat._subregion_topk(jnp.asarray(vals), jnp.asarray(mask), cfg_j, 4,
                                             largest=largest)
        idx_t, ok_t = t_feat._subregion_topk(T(vals), T(mask), cfg_t, 4, largest=largest)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


# ----------------------------------------------------------------------
# lidar/voxel_map.py, lidar/odometry.py
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(4)
    pts = (rng.randn(600, 3) * [6.0, 6.0, 1.5]).astype(np.float32)
    pts[100:140] = pts[60:100] + 0.01  # voxel mates
    valid = rng.rand(600) > 0.1
    normals = rng.randn(600, 3).astype(np.float32)
    queries = (pts[:80] + rng.randn(80, 3) * 0.1).astype(np.float32)
    queries[-5:] += 50.0  # nothing near
    return pts, valid, normals, queries


@pytest.mark.parametrize("k", [1, 3])
def test_voxel_map_build_and_knn_match(cloud, k):
    """Sorted order, keys, neighbour indices and validity exact; squared
    distances to 1e-6."""
    pts, valid, normals, queries = cloud
    vm_j = j_vmap.build(jnp.asarray(pts), jnp.asarray(valid), 0.8, payload=jnp.asarray(normals))
    vm_t = t_vmap.build(T(pts), T(valid), 0.8, payload=T(normals))
    np.testing.assert_array_equal(vm_t.keys.numpy(), np.asarray(vm_j.keys))
    np.testing.assert_array_equal(vm_t.points.numpy(), np.asarray(vm_j.points))
    np.testing.assert_array_equal(vm_t.payload.numpy(), np.asarray(vm_j.payload))
    np.testing.assert_array_equal(vm_t.valid.numpy(), np.asarray(vm_j.valid))
    conv = convert.voxel_map(vm_j)
    assert torch.equal(conv.keys, vm_t.keys) and math.isclose(conv.cell, vm_t.cell, rel_tol=1e-6)
    i_j, d_j, ok_j = j_vmap.knn(vm_j, jnp.asarray(queries), k=k, max_dist=0.45)
    i_t, d_t, ok_t = t_vmap.knn(vm_t, T(queries), k=k, max_dist=0.45)
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert ok[:, 0].sum() > 40 and not ok[-5:].any()
    np.testing.assert_array_equal(i_t.numpy()[ok], np.asarray(i_j)[ok])
    np.testing.assert_allclose(d_t.numpy()[ok], np.asarray(d_j)[ok], rtol=1e-6, atol=1e-9)
    if k == 1:  # rows with no candidate at all fall back to candidate 0 in both
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_voxel_downsample_and_local_map_match(cloud):
    """Representatives (the first point of each voxel in key order) and
    their slots exact, with and without payload columns, under and over the
    capacity."""
    pts, valid, normals, _ = cloud
    for cap in (512, 100):
        o_j, v_j = j_vmap.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), 0.4, cap)
        o_t, v_t = t_vmap.voxel_downsample(T(pts), T(valid), 0.4, cap)
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        np.testing.assert_array_equal(o_t.numpy()[np.asarray(v_j)],
                                      np.asarray(o_j)[np.asarray(v_j)])
        n = int(np.asarray(v_j).sum())
        assert 50 < n <= cap and n < valid.sum()
    stacked = np.concatenate([pts, normals], -1)
    o_j, v_j = j_odo._voxel_downsample_payload(jnp.asarray(stacked), jnp.asarray(valid), 0.4, 512)
    o_t, v_t = t_odo._voxel_downsample_payload(T(stacked), T(valid), 0.4, 512)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(o_t.numpy()[np.asarray(v_j)], np.asarray(o_j)[np.asarray(v_j)])
    lm_j = j_odo.build_local_map(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pts[::-1]),
                                 jnp.asarray(valid), jnp.asarray(normals), j_odo.OdomConfig())
    lm_t = t_odo.build_local_map(T(pts), T(valid), T(pts[::-1].copy()), T(valid), T(normals),
                                 t_odo.OdomConfig())
    for vm_t, vm_j in zip(lm_t, convert.local_map(lm_j)):
        for a, b in zip(vm_t, vm_j):
            assert math.isclose(a, b, rel_tol=1e-6) if isinstance(a, float) else torch.equal(a, b)


# ----------------------------------------------------------------------
# factors/lidar.py, optim/pose_opt.py
# ----------------------------------------------------------------------


def test_lidar_factors_match_and_agree_with_finite_differences():
    """Residuals and Jacobians to 1e-5 of the JAX package's; Jacobians to
    1e-6 of central differences of the residual in float64."""
    rng = np.random.RandomState(7)
    xi = np.array([0.5, -0.3, 0.2, 0.03, -0.02, 0.05], np.float32)
    p = (rng.randn(20, 3) * 5).astype(np.float32)
    n = rng.randn(20, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.randn(20).astype(np.float32)
    q = (rng.randn(20, 3) * 5).astype(np.float32)
    q2 = (rng.randn(20, 3) * 5).astype(np.float32)
    pose_j, pose_t = j_se3.exp(jnp.asarray(xi)), t_se3.exp(T(xi))
    cases = [
        (j_lf.plane_residual_jac, t_lf.plane_residual_jac, (n, d)),
        (j_lf.point_residual_jac, t_lf.point_residual_jac, (q,)),
        (j_lf.edge_line_residual_jac, t_lf.edge_line_residual_jac, (q, q2)),
    ]
    np.testing.assert_allclose(t_lf.point_world(pose_t, T(p)).numpy(),
                               np.asarray(j_lf.point_world(pose_j, jnp.asarray(p))), atol=1e-5)
    for fn_j, fn_t, extra in cases:
        r_j, J_j = fn_j(pose_j, jnp.asarray(p), *[jnp.asarray(e) for e in extra])
        r_t, J_t = fn_t(pose_t, T(p), *[T(e) for e in extra])
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-5)
        np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=1e-5)
        # Finite differences, float64, left-multiplicative update.
        pose64 = t_se3.SE3(pose_t.R.double(), pose_t.t.double())
        args64 = [T(p).double()] + [T(e).double() for e in extra]
        J64 = fn_t(pose64, *args64)[1]
        eps = 1e-6
        for k in range(6):
            dx = torch.zeros(6, dtype=torch.float64)
            dx[k] = eps
            r_plus = fn_t(t_se3.retract(pose64, dx), *args64)[0]
            r_minus = fn_t(t_se3.retract(pose64, -dx), *args64)[0]
            np.testing.assert_allclose(J64[..., k].numpy(),
                                       ((r_plus - r_minus) / (2 * eps)).numpy(), atol=1e-6)


def _lidar_pose_problem():
    """tests/test_pose_opt.py::test_lidar_tight_coupling_improves_pose's
    problem from a numpy seed: 25 noisy visual points, 120 exact flat points
    on three planes, one masked-out corner row plus 30 corner points."""
    rng = np.random.RandomState(3)
    X = (rng.randn(25, 3) * [8.0, 4.0, 6.0] + [0, 0, 20.0]).astype(np.float32)
    xi = np.concatenate([rng.randn(3) * 0.5, rng.randn(3) * 0.05]).astype(np.float32)
    T_true = j_se3.exp(jnp.asarray(xi))
    cam = j_pose_opt.reproj.Camera(fx=718.856, fy=718.856, cx=607.19, cy=185.22, bf=386.1448)
    x_c = np.asarray(j_se3.act(T_true, jnp.asarray(X)))
    uv = np.asarray(cam.project(jnp.asarray(x_c))) + rng.randn(25, 2) * 8.0
    ur = uv[:, 0] - cam.bf / x_c[:, 2] + rng.randn(25) * 8.0
    uvr = np.concatenate([uv, np.where(rng.rand(25) < 0.5, ur, -1.0)[:, None]], -1)
    normals = np.eye(3, dtype=np.float32)[[2, 1, 0]]
    ds = np.array([-25.0, 3.0, -8.0], np.float32)
    pts_w, nrm, dd = [], [], []
    for i in range(3):
        p = rng.randn(40, 3) * 6.0
        p = p - (p @ normals[i] + ds[i])[:, None] * normals[i][None]
        pts_w.append(p)
        nrm.append(np.tile(normals[i][None], (40, 1)))
        dd.append(np.full(40, ds[i]))
    pts_w = np.concatenate(pts_w).astype(np.float32)
    corners_w = (rng.randn(31, 3) * 6.0).astype(np.float32)
    corner_valid = np.ones(31, bool)
    corner_valid[0] = False
    arrays = dict(
        flat_pts=np.asarray(j_se3.act(T_true, jnp.asarray(pts_w))),
        plane_n=np.concatenate(nrm).astype(np.float32),
        plane_d=np.concatenate(dd).astype(np.float32),
        flat_valid=np.ones(120, bool),
        corner_pts=np.asarray(j_se3.act(T_true, jnp.asarray(corners_w))),
        corner_target=corners_w + rng.randn(31, 3).astype(np.float32) * 0.02,
        corner_valid=corner_valid,
    )
    vis = dict(points_w=X, uvr=uvr.astype(np.float32), inv_sigma2=np.ones(25, np.float32),
               valid=np.ones(25, bool))
    start = np.array([0.4, -0.3, 0.3, 0.03, -0.02, 0.04], np.float32)
    return cam, xi, start, vis, arrays


def test_lidar_system_and_fused_optimize_pose_match():
    """`_lidar_system`: H, b and chi2 to 1e-4 relative, with and without the
    Huber kernel. `optimize_pose(lidar_obs=...)`: the fused pose within 1% of
    the correction made (~0.6 m, 0.05 rad), chi2 within 1%, and the fused
    pose nearer the true one than the visual pose, as the JAX test asks."""
    cam, xi, start, vis, arrays = _lidar_pose_problem()
    lobs_j = j_pose_opt.LidarObs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    lobs_t = t_pose_opt.LidarObs(**{k: T(v) for k, v in arrays.items()})
    obs_j = j_pose_opt.VisualObs(**{k: jnp.asarray(v) for k, v in vis.items()})
    obs_t = t_pose_opt.VisualObs(**{k: T(v) for k, v in vis.items()})
    T_true_j = j_se3.exp(jnp.asarray(xi))
    T0_j = j_se3.retract(T_true_j, jnp.asarray(start))
    T0_t = t_se3.retract(t_se3.exp(T(xi)), T(start))
    for delta in (None, 2.0):
        H_j, b_j, c_j = j_pose_opt._lidar_system(T0_j, lobs_j, delta)
        H_t, b_t, c_t = t_pose_opt._lidar_system(T0_t, lobs_t, delta)
        scale = float(np.abs(np.asarray(H_j)).max())
        np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), atol=1e-4 * scale)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j),
                                   atol=1e-4 * float(np.abs(np.asarray(b_j)).max()))
        np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-4)
    res_j = j_pose_opt.optimize_pose(T0_j, obs_j, cam, lidar_obs=lobs_j)
    res_t = t_pose_opt.optimize_pose(T0_t, obs_t, convert.camera(cam), lidar_obs=lobs_t)
    np.testing.assert_allclose(res_t.pose.t.numpy(), np.asarray(res_j.pose.t), atol=6e-3)
    np.testing.assert_allclose(res_t.pose.R.numpy(), np.asarray(res_j.pose.R), atol=5e-4)
    np.testing.assert_allclose(float(res_t.chi2), float(res_j.chi2), rtol=1e-2)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 1
    vis_only = t_pose_opt.optimize_pose(T0_t, obs_t, convert.camera(cam))
    T_true_t = convert.se3(T_true_j)
    err_fused = float(torch.linalg.norm(t_se3.local_delta(res_t.pose, T_true_t)[:3]))
    err_vis = float(torch.linalg.norm(t_se3.local_delta(vis_only.pose, T_true_t)[:3]))
    assert err_fused < err_vis, (err_fused, err_vis)


# ----------------------------------------------------------------------
# pipeline/frame.py
# ----------------------------------------------------------------------


def test_project_cloud_to_depth_image_matches_and_nan_rows_are_inert():
    """Exact against the JAX package (a scatter-min of the same z values);
    NaN rows and a validity mask change nothing they should not."""
    rng = np.random.RandomState(1)
    pts = (rng.randn(9000, 3) * [6.0, 6.0, 15.0] + [0.0, 0.0, 10.0]).astype(np.float32)
    d_j = np.asarray(j_frame.project_cloud_to_depth_image(jnp.asarray(pts), DEFAULT_CAM, 48, 64))
    cam = convert.camera(DEFAULT_CAM)
    d_t = t_frame.project_cloud_to_depth_image(T(pts), cam, 48, 64).numpy()
    np.testing.assert_array_equal(d_t, d_j)
    assert (d_t > 0).sum() > 30
    padded = np.concatenate([pts, np.full((500, 3), np.nan, np.float32)])
    d_pad = t_frame.project_cloud_to_depth_image(T(padded), cam, 48, 64).numpy()
    np.testing.assert_array_equal(d_pad, d_t)
    keep = rng.rand(9000) > 0.5
    d_mask_j = np.asarray(j_frame.project_cloud_to_depth_image(
        jnp.asarray(pts), DEFAULT_CAM, 48, 64, valid=jnp.asarray(keep)))
    d_mask_t = t_frame.project_cloud_to_depth_image(T(pts), cam, 48, 64, valid=T(keep)).numpy()
    np.testing.assert_array_equal(d_mask_t, d_mask_j)


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------

# Camera -> LiDAR basis of tests/test_e2e_fusion.py: x_l = z_c, y_l = -x_c, z_l = -y_c.
R_CL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
LCFG = dict(num_rings=48, elev_min_deg=-30.0, elev_max_deg=30.0, horizon_res_deg=0.4,
            ground_z=-100.0, min_range=0.5, max_range=90.0)
J_CFG = SystemConfig(orb=j_orb.ORBConfig(max_features=600), lidar=j_feat.LidarConfig(**LCFG),
                     tracking=TrackingConfig(kf_max_interval=1),
                     max_keyframes=32, max_landmarks=6000)


def depth_to_lidar_cloud(depth_img, cam):
    """Backproject the rendered depth image into a LiDAR-frame cloud (pixels
    without depth give range 0 and fall to `min_range`)."""
    d = np.asarray(depth_img)
    H, W = d.shape
    vs, us = np.mgrid[0:H, 0:W]
    z = d.reshape(-1)
    x = (us.reshape(-1).astype(np.float32) - cam.cx) * z / cam.fx
    y = (vs.reshape(-1).astype(np.float32) - cam.cy) * z / cam.fy
    return np.stack([x, y, z], -1).astype(np.float32) @ R_CL


def _fusion_scene(n_frames):
    world = t_synthetic.SyntheticWorld(seed=9, n_points=1000)
    poses = t_synthetic.forward_trajectory(n_frames, step=0.35)
    cam = t_synthetic.DEFAULT_CAM
    frames = []
    for pose in poses:
        img, depth = world.render(pose, cam)
        frames.append((img, depth_to_lidar_cloud(depth, cam)))
    return poses, frames


def _gt(poses, n):
    out = []
    for pose in poses[:n]:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = np.asarray(pose.R), np.asarray(pose.t)
        out.append(np.linalg.inv(M))
    return np.stack(out)


@pytest.fixture(scope="module")
def fusion_state():
    """The JAX system after three fusion frames (three keyframes with LiDAR
    clouds; local mapping left out), the fourth frame's features, and the
    tracker's visual and LiDAR local maps."""
    _, frames = _fusion_scene(4)
    system = SlamSystem(DEFAULT_CAM, J_CFG)
    system.tracker.new_kf_callback = None
    T_cl = (jnp.asarray(R_CL), jnp.zeros(3))
    for img, cloud in frames[:3]:
        assert system.track_fusion(jnp.asarray(img), cloud, T_cam_lidar=T_cl) is not None
    assert system.num_keyframes() == 3 and system.tracker.last_lidar_matches > 20
    img, cloud = frames[3]
    frame = j_frame.build_frame_jit(jnp.asarray(img), DEFAULT_CAM, J_CFG.orb,
                                    cloud_lidar=j_feat.pad_cloud(cloud), T_cam_lidar=T_cl,
                                    lidar_cfg=J_CFG.lidar)
    tr = system.tracker
    return system, tr._gather_local_map(), tr._gather_lidar_local_map(), frame, (img, cloud)


def test_build_frame_with_cloud_matches(fusion_state):
    """The port's frame from the same image and cloud: keypoint depth equal
    where both packages found the same keypoint (ORB parity is held in
    tests/test_torch_frontend.py), LiDAR features (camera frame) equal to
    1e-5, masks exact; flat normals to 5e-3 (this cloud is noise-free, so a
    window's points lie exactly on a plane and the float32 normal equations
    are near-singular in the plane's directions)."""
    _, _, _, frame_j, (img, cloud) = fusion_state
    frame_t = t_frame.build_frame(T(img), t_synthetic.DEFAULT_CAM,
                                  convert.orb_config(J_CFG.orb), cloud_lidar=T(cloud),
                                  T_cam_lidar=(R_CL, np.zeros(3, np.float32)),
                                  lidar_cfg=t_feat.LidarConfig(**LCFG))
    lf_j = frame_j.lidar
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        v = np.asarray(getattr(lf_j, name + "_valid"))
        np.testing.assert_array_equal(getattr(frame_t.lidar, name + "_valid").numpy(), v)
        np.testing.assert_allclose(getattr(frame_t.lidar, name).numpy()[v],
                                   np.asarray(getattr(lf_j, name))[v], atol=1e-5)
    v = np.asarray(lf_j.flat_valid)
    assert v.sum() > 20
    np.testing.assert_allclose(frame_t.lidar.flat_normal.numpy()[v],
                               np.asarray(lf_j.flat_normal)[v], atol=5e-3)
    same_kp = (np.abs(frame_t.kp.xy.numpy() - np.asarray(frame_j.kp.xy)).max(-1) < 1e-3) \
        & np.asarray(frame_j.kp.valid)
    assert same_kp.sum() > 400
    np.testing.assert_allclose(frame_t.depth.numpy()[same_kp],
                               np.asarray(frame_j.depth)[same_kp], atol=1e-5)
    assert (np.asarray(frame_j.depth)[same_kp] > 0).sum() > 200


def _step_args(tr):
    c = tr.cfg
    return (c.match_radius_motion, c.match_radius_local, c.min_inliers_track, c.close_depth)


def test_match_and_optimize_fused_matches(fusion_state):
    """One fused stage from the motion-model guess: pose within 1% of the
    frame step (0.35 m -> 3.5e-3; rotation 1e-3), visual inliers within 1%,
    LiDAR associations within 2."""
    system, lm, lidar_map, frame, _ = fusion_state
    tr = system.tracker
    guess_j = j_se3.retract(tr.pose, tr.velocity)
    out_j = j_tracking.match_and_optimize_fused(
        guess_j, lm, frame, DEFAULT_CAM, tr.cfg.match_radius_local, lidar_map,
        tr.cfg.lidar_match_dist, num_levels=tr.cfg.num_levels, scale_factor=tr.cfg.scale_factor)
    guess_t = t_se3.retract(convert.se3(tr.pose), T(tr.velocity))
    out_t = t_tracking.match_and_optimize_fused(
        guess_t, convert.local_map_buffer(lm), convert.frame(frame),
        convert.camera(DEFAULT_CAM), tr.cfg.match_radius_local, convert.local_map(lidar_map),
        tr.cfg.lidar_match_dist, num_levels=tr.cfg.num_levels, scale_factor=tr.cfg.scale_factor)
    np.testing.assert_allclose(out_t[0].t.numpy(), np.asarray(out_j[0].t), atol=3.5e-3)
    np.testing.assert_allclose(out_t[0].R.numpy(), np.asarray(out_j[0].R), atol=1e-3)
    n_j, nl_j = int(out_j[3]), int(out_j[4])
    assert n_j > 100 and nl_j > 20
    assert abs(int(out_t[3]) - n_j) <= max(2, 0.01 * n_j)
    assert abs(int(out_t[4]) - nl_j) <= 2


def test_fused_track_frame_step_matches(fusion_state):
    """The whole fused step (stages A, B, C): pose within 1% of the frame
    step, counts within 1%, n_lidar within 2."""
    system, lm, lidar_map, frame, _ = fusion_state
    tr = system.tracker
    kw = dict(match_dist=tr.cfg.lidar_match_dist, num_levels=tr.cfg.num_levels,
              scale_factor=tr.cfg.scale_factor)
    _, vel_j, pi_j, pf_j = j_tracking.track_frame_step(
        tr.pose, tr.velocity, lm, frame, DEFAULT_CAM, *_step_args(tr), lidar_map=lidar_map, **kw)
    _, vel_t, pi_t, pf_t = t_tracking.track_frame_step(
        convert.se3(tr.pose), T(tr.velocity), convert.local_map_buffer(lm),
        convert.frame(frame), convert.camera(DEFAULT_CAM), *_step_args(tr),
        lidar_map=convert.local_map(lidar_map), **kw)
    pf_j, pf_t = np.asarray(pf_j), pf_t.numpy()
    np.testing.assert_allclose(pf_t[:9], pf_j[:9], atol=1e-3)  # R
    np.testing.assert_allclose(pf_t[9:12], pf_j[9:12], atol=3.5e-3)  # t
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=3.5e-3)
    assert pf_j[12] > 100 and pf_j[14] > 20
    for k in (12, 13, 15):
        assert abs(pf_t[k] - pf_j[k]) <= max(2, 0.01 * pf_j[k]), k
    assert abs(pf_t[14] - pf_j[14]) <= 2  # n_lidar
    assert pf_t[16] == pf_j[16]
    valid_j = np.asarray(pi_j)[1].astype(bool)
    assert (pi_t.numpy()[1].astype(bool) != valid_j).sum() <= max(2, 0.01 * valid_j.sum())


def test_lidar_stage_matches_on_a_store_from_a_jax_run(fusion_state):
    """`_lidar_stage` of the last keyframe, each package on its own copy of
    the JAX run's store: the refined pose within 1% of the frame step, and
    moved by the stage in the same direction."""
    system, *_ = fusion_state
    store_j, store_t = copy.deepcopy(system.store), copy.deepcopy(system.store)
    kf = 2
    before = store_j.kf_t[kf].copy()
    j_local_mapping.LocalMapper(store_j, DEFAULT_CAM)._lidar_stage(kf)
    mapper = t_local_mapping.LocalMapper(store_t, convert.camera(DEFAULT_CAM), device="cpu")
    version = store_t.version
    mapper._lidar_stage(kf)
    assert mapper.num_lidar_stages == 1 and store_t.version > version
    np.testing.assert_allclose(store_t.kf_t[kf], store_j.kf_t[kf], atol=3.5e-3)
    np.testing.assert_allclose(store_t.kf_R[kf], store_j.kf_R[kf], atol=1e-3)
    moved_j, moved_t = store_j.kf_t[kf] - before, store_t.kf_t[kf] - before
    assert np.linalg.norm(moved_j - moved_t) <= 0.5 * np.linalg.norm(moved_j) + 1e-3
    # Other keyframes are untouched.
    np.testing.assert_array_equal(store_t.kf_t[:kf], system.store.kf_t[:kf])


def _run_port_fusion(n_frames):
    poses, frames = _fusion_scene(n_frames)
    cfg = t_system.SystemConfig(orb=convert.orb_config(J_CFG.orb),
                                lidar=t_feat.LidarConfig(**LCFG))
    s = t_system.SlamSystem(t_synthetic.DEFAULT_CAM, cfg, device="cpu")
    tracked, hits = 0, []
    for img, cloud in frames:
        tracked += s.track_fusion(img, cloud, T_cam_lidar=(R_CL, np.zeros(3, np.float32))) \
            is not None
        hits.append(s.tracker.last_lidar_matches)
    return s, poses, tracked, hits


def test_port_track_fusion_run():
    """tests/test_e2e_fusion.py's bars on 8 frames of its scene, in the port
    alone: all but one frame tracked, LiDAR associations > 20, the LiDAR
    stage of local BA ran, keyframes carry LiDAR clouds, ATE < 0.2 m."""
    s, poses, tracked, hits = _run_port_fusion(8)
    assert tracked >= 7, f"fusion tracking broke: {tracked}/8"
    assert max(hits) > 20 and min(hits[2:]) > 20, hits
    assert s.tracker.last_lidar_matches > 20
    assert s.num_keyframes() >= 2 and s.local_mapper.num_lidar_stages >= 1
    K = s.store.num_kf
    assert s.store.kf_corner_valid[:K].any(axis=1).all()
    assert s.store.kf_flat_valid[:K].sum() > 20
    nrm = np.linalg.norm(s.store.kf_flat_normal[:K][s.store.kf_flat_valid[:K]], axis=-1)
    np.testing.assert_allclose(nrm, 1.0, atol=1e-3)
    est = s.get_trajectory()
    ate, _ = ate_rmse(est, _gt(poses, len(est)))
    assert ate < 0.2, f"fusion ATE {ate:.3f} m"
    res = s.get_slam_result()
    assert res["lidar_corner"].shape[1] == 3 and len(res["lidar_flat"]) > 0
    assert math.isfinite(ate)


def test_system_config_converts_with_lidar():
    cfg = convert.system_config(J_CFG)
    assert cfg.lidar == t_feat.LidarConfig(**LCFG)
    assert cfg.tracking.lidar_match_dist == J_CFG.tracking.lidar_match_dist
    assert cfg.tracking.lidar_min_map_pts == 100 and cfg.tracking.lidar_map_kfs == 10
    assert convert.system_config(J_CFG._replace(lidar=None)).lidar is None
    # The asynchronous mapping worker and pipelined tracking carry across.
    assert convert.system_config(J_CFG._replace(async_mapping=True)).async_mapping
    assert not cfg.async_mapping and not cfg.tracking.pipelined
    assert convert.system_config(
        J_CFG._replace(tracking=TrackingConfig(pipelined=True))).tracking.pipelined


@pytest.mark.slow
def test_fusion_tight_coupling_tracks_in_both_packages():
    """tests/test_e2e_fusion.py's 12-frame run through both packages: all but
    one frame tracked, LiDAR associations > 20, ATE < 0.2 m, each."""
    s, poses, tracked, hits = _run_port_fusion(12)
    assert tracked >= 11 and max(hits) > 20
    est = s.get_trajectory()
    ate_t, _ = ate_rmse(est, _gt(poses, len(est)))
    assert ate_t < 0.2, ate_t
    _, frames = _fusion_scene(12)
    js = SlamSystem(DEFAULT_CAM, J_CFG._replace(tracking=TrackingConfig()))
    T_cl = (jnp.asarray(R_CL), jnp.zeros(3))
    tracked_j, hits_j = 0, 0
    for img, cloud in frames:
        tracked_j += js.track_fusion(jnp.asarray(img), cloud, T_cam_lidar=T_cl) is not None
        hits_j = max(hits_j, js.tracker.last_lidar_matches)
    assert tracked_j >= 11 and hits_j > 20
    est_j = js.get_trajectory()
    ate_j, _ = ate_rmse(est_j, _gt(poses, len(est_j)))
    assert ate_j < 0.2, ate_j


# KITTI 00-02 intrinsics at 1226x370 (cfg/KITTI00-02.yaml), as chip_smoke.py.
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448)


@pytest.mark.slow
def test_fusion_through_a_street_corner_in_both_packages():
    """Both packages over 14 frames of the street circuit through its first
    corner at KITTI size (1226x370, 2000 features, 64 x 1800-ray scans at
    the column centres, the default LidarConfig): the window turns ~22
    degrees. Every frame tracked in each, keyframe counts within one, each
    ATE < 0.5 m (tests/test_planeworld_fusion.py's bar), the camera centres
    of the two packages within 0.1 m at every frame."""
    from sqrtlm_slam_tpu.factors.reprojection import Camera as JCamera

    world = t_planeworld.street_circuit_world(seed=0)
    poses, _ = t_planeworld.circuit_trajectory(14, step=0.8, start_s=59.0)
    yaw = [math.degrees(math.atan2(*(T.R.T @ np.array([0.0, 0.0, 1.0]))[[0, 2]])) for T in poses]
    assert abs(yaw[-1] - yaw[0]) > 20.0
    jcam = JCamera(**KITTI_CAM)
    tcam = convert.camera(jcam)
    frames = []
    for i, T in enumerate(poses):
        img, _ = world.render(T, tcam, H=370, W=1226, noise_seed=i)
        raw = world.lidar_scan(T, t_planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=i)
        pts, T_cv = t_planeworld.center_scan_on_columns(raw, t_planeworld.T_CAM_VELO)
        frames.append((img, pts))
    T_cl = (T_cv[:3, :3].astype(np.float32), T_cv[:3, 3].astype(np.float32))
    j_cfg = SystemConfig(orb=j_orb.ORBConfig(max_features=2000), lidar=j_feat.LidarConfig())
    js = SlamSystem(jcam, j_cfg)
    ts = t_system.SlamSystem(tcam, convert.system_config(j_cfg), device="cpu")
    tracked_j = tracked_t = 0
    for img, pts in frames:
        tracked_j += js.track_fusion(jnp.asarray(img), jnp.asarray(pts),
                                     T_cam_lidar=tuple(jnp.asarray(a) for a in T_cl)) is not None
        tracked_t += ts.track_fusion(img, pts, T_cam_lidar=T_cl) is not None
    assert tracked_j == tracked_t == len(frames)
    assert abs(js.num_keyframes() - ts.num_keyframes()) <= 1
    gt = _gt(poses, len(poses))
    gt = np.linalg.inv(gt[0]) @ gt  # the map's frame is the first camera's
    est_j, est_t = js.get_trajectory(), ts.get_trajectory()
    for est in (est_j, est_t):
        ate, _ = ate_rmse(est, gt, align_scale=False)
        assert ate < 0.5, ate
    assert np.abs(est_j[:, :3, 3] - est_t[:, :3, 3]).max() < 0.1
