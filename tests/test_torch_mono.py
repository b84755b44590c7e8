"""The port's monocular initialization (`Tracker._initialize_mono`) and
monocular entry (`SlamSystem.track_monocular`) against the JAX package.

Scene: tests/test_e2e_mono.py's (synthetic world seed 5, 1200 points,
240x320, 600 ORB features, 0.35 m steps), where both packages initialize on
the second frame. `_initialize_mono` runs in a bare tracker of each package
(no local mapping) on the same two JAX frames; the port's initializer gets
the minimal sets the JAX tracker draws (its key 42, split once), so both
score the same hypotheses. Same keyframes; the same landmarks but for a point
that sits on a float32 gate (one of 210 here, on the parallax gate);
landmark positions within 1e-3 relative, the second keyframe's pose within
1e-4.
The port alone holds tests/test_e2e_mono.py's bars on 8 of its frames; the
15-frame run of both packages is `slow`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.mapstore import MapStore as JMapStore
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu.pipeline import tracking as j_tracking
from sqrtlm_slam_tpu.pipeline.system import SlamSystem, SystemConfig
from sqrtlm_slam_tpu.pipeline.tracking import TrackingConfig
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import synthetic as t_synthetic
from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.pipeline import initializer as t_init
from sqrtlm_slam_tpu_torch.pipeline import system as t_system
from sqrtlm_slam_tpu_torch.pipeline import tracking as t_tracking

CFG = SystemConfig(orb=j_orb.ORBConfig(max_features=600),
                   tracking=TrackingConfig(min_inliers_local=15))
STORE = dict(max_keyframes=16, max_landmarks=4000, feats_per_kf=600)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def frames():
    """The first two JAX monocular frames of the scene."""
    world = SyntheticWorld(seed=5, n_points=1200)
    out = []
    for T in forward_trajectory(2, step=0.35):
        img, _ = world.render(T, DEFAULT_CAM)
        out.append(j_frame.build_frame_jit(jnp.asarray(img), DEFAULT_CAM, CFG.orb))
    return out


def _jax_tracker():
    return j_tracking.Tracker(JMapStore(**STORE), DEFAULT_CAM, CFG.tracking)


def _port_tracker():
    return t_tracking.Tracker(t_tracking.MapStore(**STORE), convert.camera(DEFAULT_CAM),
                              convert.tracking_config(CFG.tracking), device="cpu")


def _jax_minimal_sets(jt, ref, frame):
    """The sets the JAX tracker's initializer draws at its next split."""
    from sqrtlm_slam_tpu.frontend import matching

    window = matching.projection_window_mask(ref.kp.xy, frame.kp.xy, 100.0)
    res = matching.match_descriptors(
        ref.kp.desc, frame.kp.desc, ref.kp.valid, frame.kp.valid, window_mask=window,
        max_dist=matching.TH_LOW, ratio=0.9, mutual=True, angles=(ref.kp.angle, frame.kp.angle))
    _, sub = jax.random.split(jt._key)
    kF, kH = jax.random.split(sub)

    def sample(k, m):
        g = jax.random.gumbel(k, (200, res.valid.shape[0]))
        return jax.lax.top_k(jnp.where(res.valid[None, :], g, -jnp.inf), m)[1]

    return torch.as_tensor(np.asarray(sample(kF, 8))), torch.as_tensor(np.asarray(sample(kH, 4)))


def test_initialize_mono_matches(frames, monkeypatch):
    f0, f1 = frames
    jt, tt = _jax_tracker(), _port_tracker()
    sel_F, sel_H = _jax_minimal_sets(jt, f0, f1)
    monkeypatch.setattr(t_tracking.initializer, "initialize_two_view",
                        functools.partial(t_init.initialize_two_view, sel_F=sel_F, sel_H=sel_H))
    # The first frame becomes the reference in both; the second initializes.
    assert not jt._initialize_mono(f0) and not tt._initialize_mono(convert.frame(f0))
    assert tt._init_ref is not None
    assert jt._initialize_mono(f1) and tt._initialize_mono(convert.frame(f1))
    js, ts = jt.store, tt.store
    assert ts.num_kf == js.num_kf == 2 and tt._init_ref is None
    # Landmark counts: one triangulated point of 210 sits on the parallax
    # gate (cos 0.99997997 in JAX, 0.99997985 in the port, gate 0.99998).
    assert js.num_lm > 100 and abs(ts.num_lm - js.num_lm) <= 1
    assert tt.state == t_tracking.TrackState.OK
    assert abs(tt.last_inliers - jt.last_inliers) <= 1
    # The same reference keypoints carry landmarks (up to the gate's point),
    # with the same descriptors and second-view keypoints, at the same place.
    lm_t, lm_j = ts.kf_obs_lm[0], js.kf_obs_lm[0]
    both = (lm_t >= 0) & (lm_j >= 0)
    assert both.sum() >= max((lm_t >= 0).sum(), (lm_j >= 0).sum()) - 1
    np.testing.assert_array_equal(ts.lm_desc[lm_t[both]], js.lm_desc[lm_j[both]])
    kp2_t = {l: k for k, l in enumerate(ts.kf_obs_lm[1]) if l >= 0}
    kp2_j = {l: k for k, l in enumerate(js.kf_obs_lm[1]) if l >= 0}
    assert [kp2_t[l] for l in lm_t[both]] == [kp2_j[l] for l in lm_j[both]]
    pos_t, pos_j = ts.lm_pos[lm_t[both]], js.lm_pos[lm_j[both]]
    np.testing.assert_allclose(pos_t, pos_j, rtol=1e-3, atol=1e-3 * np.abs(pos_j).max())
    np.testing.assert_allclose(ts.kf_R[:2], js.kf_R[:2], atol=1e-4)
    np.testing.assert_allclose(ts.kf_t[:2], js.kf_t[:2], atol=1e-4)
    # Median scene depth 1 in the first keyframe.
    assert abs(np.median(pos_t[:, 2]) - 1.0) < 0.05
    assert float(tt.velocity.abs().sum()) == 0.0 and len(tt.trajectory) == 1
    np.testing.assert_allclose(tt.trajectory[0][2], jt.trajectory[0][2], atol=1e-4)


def test_reference_resets_when_matching_fails(frames):
    """A second frame that matches the reference in < 100 pairs replaces it
    (both packages), and a frame with too few keypoints never becomes one."""
    f0, _ = frames
    world = SyntheticWorld(seed=11, n_points=1200)
    img, _ = world.render(forward_trajectory(1)[0], DEFAULT_CAM)
    other = j_frame.build_frame_jit(jnp.asarray(img), DEFAULT_CAM, CFG.orb)
    jt, tt = _jax_tracker(), _port_tracker()
    for f in (f0, other):
        assert not jt._initialize_mono(f)
        assert not tt._initialize_mono(convert.frame(f))
    assert jt._init_ref is other
    np.testing.assert_array_equal(tt._init_ref.kp.xy.numpy(), np.asarray(other.kp.xy))
    sparse = convert.frame(f0)._replace(kp=convert.keypoints(f0.kp)._replace(
        valid=torch.zeros(600, dtype=torch.bool)))
    t2 = _port_tracker()
    assert not t2._initialize_mono(sparse) and t2._init_ref is None


def test_frame_with_too_little_depth_waits_and_without_depth_goes_mono(frames):
    """Some depth but too little: `_initialize` returns False and takes no
    reference; no depth at all: the frame becomes the mono reference."""
    f0, _ = frames
    fr = convert.frame(f0)
    some = fr._replace(depth=torch.where(torch.arange(600) < 10, torch.ones(600),
                                         torch.zeros(600)))
    tt = _port_tracker()
    assert not tt._initialize(some) and tt._init_ref is None
    assert not tt._initialize(fr) and tt._init_ref is not None


def test_reset_clears_the_mono_reference(frames):
    s = t_system.SlamSystem(convert.camera(DEFAULT_CAM), convert.system_config(CFG),
                            device="cpu")
    assert s.track_frame(convert.frame(frames[0])) is None
    assert s.tracker._init_ref is not None
    s.reset()
    assert s.tracker._init_ref is None and s.num_keyframes() == 0


def _mono_run(n_frames):
    world = t_synthetic.SyntheticWorld(seed=5, n_points=1200)
    poses = t_synthetic.forward_trajectory(n_frames, step=0.35)
    s = t_system.SlamSystem(t_synthetic.DEFAULT_CAM, convert.system_config(CFG), device="cpu")
    tracked = sum(s.track_monocular(world.render(T, t_synthetic.DEFAULT_CAM)[0]) is not None
                  for T in poses)
    return s, poses, tracked


def _sim3_ate(s, poses):
    est = s.get_trajectory()
    gt = []
    for T in poses[-len(est):]:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = np.asarray(T.R), np.asarray(T.t)
        gt.append(np.linalg.inv(M))
    return ate_rmse(est, np.stack(gt), align_scale=True)[0]


def test_port_track_monocular_run():
    """tests/test_e2e_mono.py's bars on 8 frames of its scene, in the port
    alone: >= 2 keyframes, > 80 landmarks, all but the reference frame
    tracked, Sim3-aligned ATE < 0.4 m."""
    s, poses, tracked = _mono_run(8)
    assert s.num_keyframes() >= 2 and s.num_landmarks() > 80
    assert tracked >= 7, tracked
    assert _sim3_ate(s, poses) < 0.4


@pytest.mark.slow
def test_mono_tracks_in_both_packages():
    """tests/test_e2e_mono.py's 15-frame run through both packages."""
    s, poses, tracked = _mono_run(15)
    js = SlamSystem(DEFAULT_CAM, CFG)
    world = SyntheticWorld(seed=5, n_points=1200)
    tracked_j = sum(js.track_monocular(world.render(T, DEFAULT_CAM)[0]) is not None
                    for T in forward_trajectory(15, step=0.35))
    for sys_, n in ((s, tracked), (js, tracked_j)):
        assert sys_.num_keyframes() >= 2 and sys_.num_landmarks() > 80
        assert n >= 11, n
        assert _sim3_ate(sys_, poses) < 0.4
