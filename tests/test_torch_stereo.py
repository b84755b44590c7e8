"""The port's stereo frame (`stereo_match`, `refine_stereo_subpixel`,
`build_frame_stereo`) and stereo entry (`SlamSystem.track_stereo`,
`track_frame`) against the JAX package.

Scene: tests/test_stereo.py's pair (synthetic world seed 4, 900 points,
240x320, the right camera moved by b = bf / fx along x, the wide 1 m
baseline of its depth test). The port's ORB differs from the JAX package's on
a fifth of the descriptors (ROADMAP, measured deviations), so the module
tests feed both packages the JAX package's own keypoints and images:
match indices (u_right) exact, refined u_right and depth within 1e-4.
The port alone then holds tests/test_stereo.py's bars; the run of both
packages over its ten frames is `slow`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu.pipeline.system import SlamSystem, SystemConfig
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import synthetic as t_synthetic
from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.pipeline import frame as t_frame
from sqrtlm_slam_tpu_torch.pipeline import system as t_system

CFG = j_orb.ORBConfig(max_features=600)
WIDE = DEFAULT_CAM._replace(bf=220.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def render_pair(world, T_l, cam):
    """tests/test_stereo.py's rectified pair: (left, right, left depth)."""
    img_l, depth_l = world.render(T_l, cam)
    T_r = j_se3.SE3(T_l.R, T_l.t - jnp.array([cam.bf / cam.fx, 0.0, 0.0]))
    img_r, _ = world.render(T_r, cam)
    return np.asarray(img_l), np.asarray(img_r), np.asarray(depth_l)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's keypoints of both images of the wide-baseline pair."""
    world = SyntheticWorld(seed=4, n_points=900)
    img_l, img_r, depth = render_pair(world, forward_trajectory(1)[0], WIDE)
    ext = jax.jit(j_orb.extract, static_argnames=("cfg",))
    return img_l, img_r, depth, ext(jnp.asarray(img_l), CFG), ext(jnp.asarray(img_r), CFG)


def test_stereo_match_matches(pair):
    _, _, _, kp_l, kp_r = pair
    u_j, d_j = j_frame.stereo_match(kp_l, kp_r, WIDE.bf)
    u_t, d_t = t_frame.stereo_match(convert.keypoints(kp_l), convert.keypoints(kp_r), WIDE.bf)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))  # the same right keypoints
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-4)
    assert (u_t.numpy() >= 0).sum() > 100


def test_refine_stereo_subpixel_matches(pair):
    img_l, img_r, _, kp_l, kp_r = pair
    u0, _ = j_frame.stereo_match(kp_l, kp_r, WIDE.bf)
    u_j, d_j = j_frame.refine_stereo_subpixel(jnp.asarray(img_l), jnp.asarray(img_r), kp_l.xy,
                                              u0, WIDE.bf)
    u_t, d_t = t_frame.refine_stereo_subpixel(torch.as_tensor(img_l), torch.as_tensor(img_r),
                                              torch.as_tensor(np.asarray(kp_l.xy)),
                                              torch.as_tensor(np.asarray(u0)), WIDE.bf)
    np.testing.assert_array_equal(u_t.numpy() < 0, np.asarray(u_j) < 0)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-4)


def test_unmatched_rows_stay_unmatched_through_the_refinement():
    """u_right = -1 truncates to -1 and is clipped into the image for the
    SAD search, but the row keeps no match (JAX `astype(int32)` semantics),
    and coordinates truncate toward zero."""
    rng = np.random.RandomState(0)
    img = torch.as_tensor(rng.rand(40, 60).astype(np.float32))
    xy = torch.tensor([[30.7, 20.9], [10.2, 5.5], [-0.4, 3.0]])
    u_in = torch.tensor([-1.0, 7.9, 20.0])
    u_t, d_t = t_frame.refine_stereo_subpixel(img, img, xy, u_in, 10.0)
    u_j, d_j = j_frame.refine_stereo_subpixel(jnp.asarray(img.numpy()), jnp.asarray(img.numpy()),
                                              jnp.asarray(xy.numpy()), jnp.asarray(u_in.numpy()),
                                              10.0)
    assert float(u_t[0]) == -1.0 and float(d_t[0]) == 0.0
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def test_build_frame_stereo_composes_the_stages_and_holds_depth():
    """The port's own frame (its ORB): the stages' composition, and
    tests/test_stereo.py's depth bar (median relative error < 6% against the
    rendered depth, > 150 stereo matches)."""
    world = t_synthetic.SyntheticWorld(seed=4, n_points=900)
    T = t_synthetic.forward_trajectory(1)[0]
    cam = convert.camera(WIDE)
    img_l, depth_gt = world.render(T, cam)
    T_r = t_synthetic.Pose(T.R, T.t - np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32))
    img_r, _ = world.render(T_r, cam)
    L, R = torch.as_tensor(img_l), torch.as_tensor(img_r)
    fr = t_frame.build_frame_stereo(L, R, cam, convert.orb_config(CFG))
    kp_l = t_frame.orb.extract(L, convert.orb_config(CFG))
    kp_r = t_frame.orb.extract(R, convert.orb_config(CFG))
    u0, _ = t_frame.stereo_match(kp_l, kp_r, cam.bf)
    u1, d1 = t_frame.refine_stereo_subpixel(L, R, kp_l.xy, u0, cam.bf)
    torch.testing.assert_close(fr.uvr[:, 2], u1, rtol=0, atol=0)
    torch.testing.assert_close(fr.depth, d1, rtol=0, atol=0)
    d, xy = fr.depth.numpy(), fr.kp.xy.numpy()
    ok = d > 0
    assert ok.sum() > 120, ok.sum()  # 149 here; the JAX keypoints give 144 raw matches
    gt = depth_gt[np.clip(xy[ok, 1].astype(int), 0, 239), np.clip(xy[ok, 0].astype(int), 0, 319)]
    sel = gt > 0
    assert np.median(np.abs(d[ok][sel] - gt[sel]) / gt[sel]) < 0.06


def _stereo_frames(n, cam):
    world = t_synthetic.SyntheticWorld(seed=4, n_points=900)
    poses = t_synthetic.forward_trajectory(n, step=0.35)
    out = []
    for T in poses:
        img_l, _ = world.render(T, cam)
        T_r = t_synthetic.Pose(T.R, T.t - np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32))
        out.append((img_l, world.render(T_r, cam)[0]))
    return poses, out


def _gt(poses):
    out = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = T.R, T.t
        out.append(np.linalg.inv(M))
    return np.stack(out)


def test_port_track_stereo_run():
    """tests/test_stereo.py's tracking scene in the port alone (6 of its 10
    frames): every frame tracked, keyframes inserted, ATE < 0.1 m."""
    cam = t_synthetic.DEFAULT_CAM
    poses, frames = _stereo_frames(6, cam)
    s = t_system.SlamSystem(cam, t_system.SystemConfig(orb=convert.orb_config(CFG)), device="cpu")
    tracked = sum(s.track_stereo(l, r) is not None for l, r in frames)
    assert tracked == 6 and s.num_keyframes() >= 2
    est = s.get_trajectory()
    ate, _ = ate_rmse(est, _gt(poses[:len(est)]), align_scale=False)
    assert ate < 0.1, ate


def test_track_frame_takes_a_jax_stereo_frame():
    """`track_frame` on a stereo frame built by the JAX package (through
    `convert.frame`) initializes the map from its stereo depth."""
    world = SyntheticWorld(seed=4, n_points=900)
    img_l, img_r, _ = render_pair(world, forward_trajectory(1)[0], DEFAULT_CAM)
    fj = j_frame.build_frame_stereo_jit(jnp.asarray(img_l), jnp.asarray(img_r), DEFAULT_CAM, CFG)
    s = t_system.SlamSystem(convert.camera(DEFAULT_CAM),
                            t_system.SystemConfig(orb=convert.orb_config(CFG)), device="cpu")
    assert s.track_frame(convert.frame(fj)) is not None
    assert s.num_keyframes() == 1
    assert s.num_landmarks() == min(int((np.asarray(fj.depth) > 0).sum()), 300)


@pytest.mark.slow
def test_stereo_tracks_in_both_packages():
    """tests/test_stereo.py's 10-frame run through both packages: >= 8
    frames tracked each, ATE < 0.1 m each, keyframe counts within one."""
    cam = t_synthetic.DEFAULT_CAM
    poses, frames = _stereo_frames(10, cam)
    ts = t_system.SlamSystem(cam, t_system.SystemConfig(orb=convert.orb_config(CFG)),
                             device="cpu")
    js = SlamSystem(DEFAULT_CAM, SystemConfig(orb=CFG))
    tracked_t = sum(ts.track_stereo(l, r) is not None for l, r in frames)
    tracked_j = sum(js.track_stereo(jnp.asarray(l), jnp.asarray(r)) is not None
                    for l, r in frames)
    assert tracked_t >= 8 and tracked_j >= 8
    assert abs(ts.num_keyframes() - js.num_keyframes()) <= 1
    ates = {}  # both packages' ATEs, m: a failure prints the two side by side
    for name, s in (("port", ts), ("jax", js)):
        est = s.get_trajectory()
        ates[name] = ate_rmse(est, _gt(poses[:len(est)]), align_scale=False)[0]
    for ate in ates.values():
        assert ate < 0.1, ates


@pytest.mark.slow
def test_kitti_size_stereo_first_step_matches_the_jax_package():
    """chip_smoke.py phase 4's world at KITTI size (random binary patches,
    1226x370, 2000 features): the JAX package's stereo frames 0 and 1 go
    through both packages' trackers. The first step, predicted with zero
    velocity, lands at the same pose in both (within 2e-3 m), and both stall
    there, > 0.2 m off the 0.3 m step: a fifth of this texture's stereo
    matches are mismatches that read as near points (ROADMAP, known faults
    in the reference; scripts/stereo_scenes.py)."""
    from sqrtlm_slam_tpu.factors.reprojection import Camera as JCamera

    jcam = JCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448)
    cfg = SystemConfig(orb=j_orb.ORBConfig(max_features=2000))
    world = SyntheticWorld(seed=1, n_points=3000)
    poses = forward_trajectory(2, step=0.3)
    frames = []
    for T in poses:
        img_l, _ = world.render(T, jcam, H=370, W=1226)
        T_r = j_se3.SE3(T.R, T.t - jnp.array([jcam.bf / jcam.fx, 0.0, 0.0]))
        img_r, _ = world.render(T_r, jcam, H=370, W=1226)
        frames.append(j_frame.build_frame_stereo_jit(jnp.asarray(img_l), jnp.asarray(img_r),
                                                     jcam, cfg.orb))
    js = SlamSystem(jcam, cfg)
    ts = t_system.SlamSystem(convert.camera(jcam), convert.system_config(cfg), device="cpu")
    for f in frames:
        pj, pt = js.track_frame(f), ts.track_frame(convert.frame(f))
    c_j = -np.asarray(pj.R).T @ np.asarray(pj.t)
    c_t = -pt.R.numpy().T @ pt.t.numpy()
    c_true = (-np.asarray(poses[1].R).T @ np.asarray(poses[1].t)
              + np.asarray(poses[0].R).T @ np.asarray(poses[0].t))
    assert np.linalg.norm(c_t - c_j) < 2e-3, (c_t, c_j)
    assert np.linalg.norm(c_j - c_true) > 0.2 and np.linalg.norm(c_t - c_true) > 0.2
