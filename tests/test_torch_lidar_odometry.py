"""Standalone LiDAR odometry of the port (`lidar/odometry.py`: `align_scan`,
`DOF_PRESETS`, `LidarOdometry`; `lidar/backend.py`; the SE(3) factor of
`factors/pose_graph.py`) against the JAX package.

Inputs are tests/test_lidar.py's and tests/test_lidar_modes.py's: a world of
corner points and three planes, made by the JAX package from its key, its
local map built by `build_local_map` and handed to the port through
`convert`; a drifted pose chain from tests/test_lidar_backend.py's generator.
Tolerances: poses within 1e-4 (float32 Gauss-Newton with different
summation orders), the SE(3) residual and Jacobians within 1e-5, the graph's
fields equal, the backend's chi2 rtol 1e-3. A raw-scan run of
`LidarOdometry.process` over a small street (16 rings x 360 rays, yawed to
the column centres) holds the port's own bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.factors import pose_graph as j_pg
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.lidar import backend as j_backend
from sqrtlm_slam_tpu.lidar import features as j_feat
from sqrtlm_slam_tpu.lidar import odometry as j_odo
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import planeworld as t_planeworld
from sqrtlm_slam_tpu_torch.factors import pose_graph as t_pg
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.lidar import backend as t_backend
from sqrtlm_slam_tpu_torch.lidar import features as t_feat
from sqrtlm_slam_tpu_torch.lidar import odometry as t_odo

KEY_ODO = jax.random.PRNGKey(44)  # tests/test_lidar.py
KEY_MODES = jax.random.PRNGKey(7)  # tests/test_lidar_modes.py
NORMALS = np.array([[0.0, 0, 1], [0, 1.0, 0], [1.0, 0, 0]], np.float32)
OFFSETS = np.array([1.8, -6.0, -20.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def world_features(key):
    """tests/test_lidar.py's world: 300 corner points and 600 points on
    three planes with their normals (JAX arrays)."""
    k1, _, k3 = jax.random.split(key, 3)
    corners_w = jax.random.normal(k1, (300, 3)) * jnp.array([15.0, 6.0, 2.0])
    flats, ns = [], []
    for i in range(3):
        k3, sub = jax.random.split(k3)
        p = jax.random.normal(sub, (200, 3)) * 8.0
        n = jnp.asarray(NORMALS[i])
        p = p - (p @ n + OFFSETS[i])[:, None] * n[None]
        flats.append(p)
        ns.append(jnp.tile(n[None], (200, 1)))
    return corners_w, jnp.concatenate(flats), jnp.concatenate(ns)


def jax_map(corners_w, flats_w, normals_w, cfg=j_odo.OdomConfig()):
    return j_odo.build_local_map(corners_w, jnp.ones(corners_w.shape[0], bool), flats_w,
                                 jnp.ones(flats_w.shape[0], bool), normals_w, cfg)


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def ones(n):
    return torch.ones(n, dtype=torch.bool)


def assert_pose_close(pose_t, pose_j, atol=1e-4):
    np.testing.assert_allclose(pose_t.R.numpy(), np.asarray(pose_j.R), atol=atol)
    np.testing.assert_allclose(pose_t.t.numpy(), np.asarray(pose_j.t), atol=atol)


def test_odom_config_defaults_match():
    assert t_odo.OdomConfig()._asdict() == j_odo.OdomConfig()._asdict()
    assert set(t_odo.DOF_PRESETS) == set(j_odo.DOF_PRESETS)
    for k, v in t_odo.DOF_PRESETS.items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), np.asarray(j_odo.DOF_PRESETS[k]))


@pytest.mark.parametrize("dof", [None, "z_rot_xy_trans", "xyz_rot_xyz_trans"])
def test_align_scan_matches(dof):
    """tests/test_lidar.py's alignment (pose off by 0.4 m / 2 deg), whole and
    with DoF masks."""
    pose_true = j_se3.exp(jnp.array([0.5, -0.3, 0.2, 0.03, -0.02, 0.05]))
    corners_w, flats_w, normals_w = world_features(KEY_ODO)
    lm = jax_map(corners_w, flats_w, normals_w)
    corner_s = j_se3.act(pose_true, corners_w[:150])
    flat_s = j_se3.act(pose_true, flats_w[::2])
    pose0 = j_se3.retract(pose_true, jnp.array([0.3, 0.2, -0.2, 0.02, 0.03, -0.02]))
    cfg = j_odo.OdomConfig()
    mask = None if dof is None else j_odo.DOF_PRESETS[dof]
    pj, sj = j_odo.align_scan(pose0, corner_s, jnp.ones(150, bool), flat_s,
                              jnp.ones(flat_s.shape[0], bool), lm, cfg, dof_mask=mask)
    pt, st = t_odo.align_scan(convert.se3(pose0), T(corner_s), ones(150), T(flat_s),
                              ones(flat_s.shape[0]), convert.local_map(lm),
                              t_odo.OdomConfig(), dof_mask=None if dof is None
                              else t_odo.DOF_PRESETS[dof])
    assert_pose_close(pt, pj)
    assert int(st["matches"]) == int(sj["matches"])
    np.testing.assert_allclose(float(st["chi2"]), float(sj["chi2"]), rtol=1e-3, atol=1e-5)
    if dof is None:
        err = t_se3.local_delta(pt, convert.se3(pose_true))
        assert float(err[:3].norm()) < 0.05 and float(err[3:].norm()) < 0.01


def test_z_trans_preset_moves_only_tz():
    """tests/test_lidar_modes.py's DoF-restricted solve in both packages: tz
    recovered, every other DoF untouched."""
    pose_true = j_se3.exp(jnp.array([0.0, 0.0, 0.25, 0.0, 0.0, 0.0]))
    corners_w, flats_w, normals_w = world_features(KEY_MODES)
    lm = jax_map(corners_w, flats_w, normals_w)
    corner_s = j_se3.act(pose_true, corners_w[:150])
    flat_s = j_se3.act(pose_true, flats_w[::2])
    pj, _ = j_odo.align_scan(j_se3.identity(), corner_s, jnp.ones(150, bool), flat_s,
                             jnp.ones(flat_s.shape[0], bool), lm, j_odo.OdomConfig(),
                             dof_mask=j_odo.DOF_PRESETS["z_trans"])
    pt, _ = t_odo.align_scan(t_se3.identity(), T(corner_s), ones(150), T(flat_s),
                             ones(flat_s.shape[0]), convert.local_map(lm), t_odo.OdomConfig(),
                             dof_mask=t_odo.DOF_PRESETS["z_trans"])
    assert_pose_close(pt, pj)
    d0 = t_se3.local_delta(pt, t_se3.identity()).numpy()
    np.testing.assert_allclose(d0[[0, 1, 3, 4, 5]], 0.0, atol=1e-5)
    assert abs(float(t_se3.local_delta(pt, convert.se3(pose_true))[2])) < 0.05


def _features_at(Tj, corners_w, flats_w, normals_w):
    """A JAX LidarFeatures scan of the world seen from T (sensor frame)."""
    Nc, Nf = corners_w.shape[0], flats_w.shape[0]
    return j_feat.LidarFeatures(
        sharp=j_se3.act(Tj, corners_w), sharp_valid=jnp.ones(Nc, bool),
        less_sharp=j_se3.act(Tj, corners_w), less_sharp_valid=jnp.ones(Nc, bool),
        flat=j_se3.act(Tj, flats_w), flat_normal=jnp.einsum("ij,nj->ni", Tj.R, normals_w),
        flat_d=jnp.zeros(Nf), flat_valid=jnp.ones(Nf, bool),
        less_flat=j_se3.act(Tj, flats_w), less_flat_valid=jnp.ones(Nf, bool))


def test_process_features_sequence_matches():
    """tests/test_lidar.py's six-step odometry sequence (keyframes every
    0.3 m): the same pose at every step, the same keyframe count."""
    corners_w, flats_w, _ = world_features(KEY_ODO)
    corner_s0 = corners_w[:150]
    flat_s0 = flats_w[::2]
    scores = jnp.stack([jnp.abs(flat_s0 @ jnp.asarray(n) + d) for n, d in zip(NORMALS, OFFSETS)])
    n_w = jnp.asarray(NORMALS)[jnp.argmin(scores, axis=0)]
    cfg = j_odo.OdomConfig()._replace(kf_dist=0.3)
    jo = j_odo.LidarOdometry(cfg)
    to = t_odo.LidarOdometry(t_odo.OdomConfig(**cfg._asdict()), device="cpu")
    for i in range(6):
        Ti = j_se3.exp(jnp.array([0.25 * i, 0.0, 0.0, 0.0, 0.0, 0.0]))
        f = _features_at(Ti, corner_s0, flat_s0, n_w)
        pj = jo.process_features(f)
        pt = to.process_features(convert.lidar_features(f))
        assert_pose_close(pt, pj)
    assert to.num_keyframes == jo.num_keyframes >= 3
    assert float(t_se3.local_delta(pt, convert.se3(Ti))[:3].norm()) < 0.1


def test_localization_mode_matches_and_never_grows_the_map():
    """tests/test_lidar_modes.py's localisation run in both packages."""
    corners_w, flats_w, normals_w = world_features(KEY_MODES)
    cfg = j_odo.OdomConfig()._replace(kf_dist=0.1)
    jo = j_odo.LidarOdometry(cfg)
    to = t_odo.LidarOdometry(t_odo.OdomConfig(**cfg._asdict()), device="cpu")
    lo = t_odo.LidarOdometry(device="cpu")
    lo.mode = "localization"
    with pytest.raises(RuntimeError):  # no prior map
        lo.process_features(convert.lidar_features(_features_at(j_se3.identity(), corners_w,
                                                                flats_w, normals_w)))
    args = (np.asarray(corners_w), np.ones(300, bool), np.asarray(flats_w), np.ones(600, bool),
            np.asarray(normals_w))
    jo.set_prior_map(*args)
    to.set_prior_map(*args)
    assert to.mode == jo.mode == "localization"
    for i in range(4):
        Ti = j_se3.exp(jnp.array([0.2 * i, 0.0, 0.0, 0.0, 0.0, 0.0]))
        f = _features_at(Ti, corners_w, flats_w, normals_w)
        pj = jo.process_features(f)
        pt = to.process_features(convert.lidar_features(f))
        assert_pose_close(pt, pj)
    assert float(t_se3.local_delta(pt, convert.se3(Ti))[:3].norm()) < 0.1
    assert to.num_keyframes == jo.num_keyframes == 0


def test_se3_relative_residual_jac_matches():
    rng = np.random.RandomState(1)

    def poses(n):
        return j_se3.exp(jnp.asarray(rng.randn(n, 6).astype(np.float32) * [1, 1, 1, .3, .3, .3]))

    Ti, Tj, Tm = poses(12), poses(12), poses(12)
    rj, Jij, Jjj = j_pg.se3_relative_residual_jac(Ti, Tj, Tm)
    rt, Jit, Jjt = t_pg.se3_relative_residual_jac(convert.se3(Ti), convert.se3(Tj),
                                                  convert.se3(Tm))
    for a, b in ((rt, rj), (Jit, Jij), (Jjt, Jjj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # One edge (no batch dims) too.
    r1, Ji1, Jj1 = t_pg.se3_relative_residual_jac(*(t_se3.SE3(p.R[0], p.t[0]) for p in (
        convert.se3(Ti), convert.se3(Tj), convert.se3(Tm))))
    np.testing.assert_allclose(Ji1.numpy(), np.asarray(Jij[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r1.numpy(), np.asarray(rj[0]), rtol=1e-5, atol=1e-5)


def drifted_chain(K=20, drift=0.03, seed=0):
    """tests/test_lidar_backend.py's generator: (true, drifted) JAX chains."""
    rng = np.random.RandomState(seed)
    true = [j_se3.identity()]
    for k in range(1, K):
        step = jnp.asarray(np.array([0.5, 0.02 * np.sin(k), 0.0, 0, 0, 0.02]), dtype=jnp.float32)
        true.append(j_se3.compose(j_se3.exp(step), true[-1]))
    est = [true[0]]
    for k in range(1, K):
        T_rel = j_se3.compose(true[k], j_se3.inverse(true[k - 1]))
        noise = jnp.asarray(rng.normal(0, drift, 6) * np.array([1, 1, 1, 0.2, 0.2, 0.2]),
                            dtype=jnp.float32)
        est.append(j_se3.compose(j_se3.retract(T_rel, noise), est[-1]))
    return true, est


def _graphs(loop=True, anchors=False):
    true, est = drifted_chain(K=15 if anchors else 20, drift=0.05 if anchors else 0.03)
    K = len(true)
    edges = [(0, K - 1, j_se3.compose(true[K - 1], j_se3.inverse(true[0])))] if loop else []
    anc = [(k, -np.asarray(true[k].R).T @ np.asarray(true[k].t)) for k in (5, 10, 14)] \
        if anchors else ()
    kw = dict(loop_info=5.0) if loop else dict(anchor_info=50.0)
    gj = j_backend.build_chain_graph(est, edges, anchors=anc, **kw)
    gt = t_backend.build_chain_graph([convert.se3(p) for p in est],
                                     [(i, j, convert.se3(T)) for i, j, T in edges],
                                     anchors=anc, **kw)
    return true, gj, gt


@pytest.mark.parametrize("case", ["loop", "gnss"])
def test_build_chain_graph_fields_equal(case):
    _, gj, gt = _graphs(loop=case == "loop", anchors=case == "gnss")
    for name in t_backend.Se3Graph._fields:
        a, b = getattr(gt, name).numpy(), np.asarray(getattr(gj, name))
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


@pytest.mark.parametrize("case", ["loop", "gnss"])
def test_optimize_se3_graph_matches(case):
    """tests/test_lidar_backend.py's loop and GNSS graphs: poses within 1e-4,
    chi2 rtol 1e-3; the loop edge cuts the end drift below 0.3 x, the
    anchors pin their positions within 0.05 m."""
    true, gj, gt = _graphs(loop=case == "loop", anchors=case == "gnss")
    out_j, chi2_j = j_backend.optimize_se3_graph(gj, num_iters=25)
    out_t, chi2_t = t_backend.optimize_se3_graph(gt, num_iters=25)
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=1e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=1e-4)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=1e-3, atol=1e-7)
    K = out_t.R.shape[0]
    if case == "loop":
        def err(R, t):
            d = t_se3.local_delta(t_se3.SE3(R, t), convert.se3(true[K - 1]))
            return float(d[:3].norm())

        assert err(out_t.R[-1], out_t.t[-1]) < 0.3 * err(gt.R[-1], gt.t[-1])
        assert float(chi2_t) < 1.0
    else:
        for k in (5, 10, 14):
            C = -out_t.R[k].numpy().T @ out_t.t[k].numpy()
            assert np.linalg.norm(C - (-np.asarray(true[k].R).T @ np.asarray(true[k].t))) < 0.05


def test_backend_for_loop_and_gnss_match():
    """`record_pose` + `backend_for_loop` / `backend_for_gnss` of both
    odometry objects on the same recorded chain."""
    true, est = drifted_chain(K=12)
    K = len(est)
    T_loop = j_se3.compose(true[K - 1], j_se3.inverse(true[0]))
    anchors = [(k, -np.asarray(true[k].R).T @ np.asarray(true[k].t)) for k in (4, 8)]
    jo, to = j_odo.LidarOdometry(), t_odo.LidarOdometry(device="cpu")
    for p in est:
        jo.pose, to.pose = p, convert.se3(p)
        jo.record_pose()
        to.record_pose()
    cj = jo.backend_for_loop(0, K - 1, T_loop)
    ct = to.backend_for_loop(0, K - 1, convert.se3(T_loop))
    for a, b in zip(ct, cj):
        assert_pose_close(a, b)
    assert_pose_close(to.pose, jo.pose)
    cj = jo.backend_for_gnss(anchors)
    ct = to.backend_for_gnss(anchors)
    for a, b in zip(ct, cj):
        assert_pose_close(a, b)


def test_process_runs_raw_scans_of_a_street():
    """`LidarOdometry.process` on raw scans (the features extracted inside),
    in the port alone: 6 scans 0.5 m apart on tests/test_torch_fusion.py's
    small street, 16 rings x 360 rays yawed to the column centres; every scan
    after the first associates > 100 features and the last pose is within
    0.1 m of the truth (LiDAR frame, relative to the first scan)."""
    world = t_planeworld.street_circuit_world(seed=0, A=12.0, B=8.0, half_width=4.0,
                                              texel=0.05, panel_spacing=6.0)
    poses, _ = t_planeworld.circuit_trajectory(6, A=12.0, B=8.0, corner_r=3.0, step=0.5)
    odo = t_odo.LidarOdometry(feat_cfg=t_feat.LidarConfig(num_rings=16, horizon_res_deg=1.0),
                              device="cpu")
    for i, Tc in enumerate(poses):
        raw = world.lidar_scan(Tc, t_planeworld.T_CAM_VELO, n_rings=16, n_azimuth=360,
                               noise_seed=i)
        pts, T_cl = t_planeworld.center_scan_on_columns(raw, t_planeworld.T_CAM_VELO, 1.0)
        pose = odo.process(pts)
        if i:
            assert int(odo.last_stats["matches"]) > 100

    def T_wl(Tc):  # LiDAR -> world: (T_cw)^-1 T_cl
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = Tc.R, Tc.t
        return np.linalg.inv(M) @ T_cl

    rel = np.linalg.inv(T_wl(poses[0])) @ T_wl(poses[-1])
    est = -pose.R.numpy().T @ pose.t.numpy()  # the last scan's centre in the first's frame
    assert np.linalg.norm(est - rel[:3, 3]) < 0.1
    assert odo.num_keyframes >= 1
