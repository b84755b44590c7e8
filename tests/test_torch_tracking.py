"""Port tracking (pose-only LM, `track_frame_step`) against the JAX package.

The JAX system runs the first frames of the e2e scene; the tracker's state at
the next frame (pose, velocity, local map, frame features) crosses to the
port through `convert`, so both packages run one tracking step on identical
inputs. Tolerances: poses agree to 1e-3 m / 1e-4 (float32 LM on a ~10 px
residual scale, different summation orders); matches and inliers to 1%
(a float32 difference can move a projection across a window border or a
chi-square gate).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.optim import pose_opt as j_pose_opt
from sqrtlm_slam_tpu.pipeline import SlamSystem, SystemConfig, TrackingConfig
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu.pipeline import tracking as j_tracking
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.optim import pose_opt as t_pose_opt
from sqrtlm_slam_tpu_torch.pipeline import tracking as t_tracking

CFG = SystemConfig(
    orb=j_orb.ORBConfig(max_features=600),
    tracking=TrackingConfig(init_min_depth_kp=80, local_map_capacity=1024),
    max_keyframes=64, max_landmarks=8000,
)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _visual_obs(seed, E=300):
    rng = np.random.RandomState(seed)
    xi = np.array([0.05, -0.02, 0.1, 0.01, -0.02, 0.015], np.float32)
    T = j_se3.exp(jnp.asarray(xi))
    X = (rng.randn(E, 3) * [5, 3, 4] + [0, 0, 15]).astype(np.float32)
    x_c = np.asarray(j_se3.act(T, jnp.asarray(X)))
    uv = np.asarray(DEFAULT_CAM.project(jnp.asarray(x_c))) + rng.randn(E, 2) * 0.5
    ur = uv[:, 0] - DEFAULT_CAM.bf / x_c[:, 2] + rng.randn(E) * 0.5
    uvr = np.concatenate([uv, np.where(rng.rand(E) < 0.6, ur, -1.0)[:, None]], 1)
    uvr[rng.rand(E) < 0.1, :2] += rng.randn(2) * 40  # gross outliers
    is2 = (1.0 / 1.44 ** rng.randint(0, 4, E)).astype(np.float32)
    valid = rng.rand(E) > 0.05
    return xi, X, uvr.astype(np.float32), is2, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_matches(seed):
    xi, X, uvr, is2, valid = _visual_obs(seed)
    guess = np.zeros(6, np.float32)
    obs_j = j_pose_opt.VisualObs(jnp.asarray(X), jnp.asarray(uvr), jnp.asarray(is2),
                                 jnp.asarray(valid))
    res_j = j_pose_opt.optimize_pose(j_se3.exp(jnp.asarray(guess)), obs_j, DEFAULT_CAM)
    obs_t = t_pose_opt.VisualObs(torch.as_tensor(X), torch.as_tensor(uvr),
                                 torch.as_tensor(is2), torch.as_tensor(valid))
    res_t = t_pose_opt.optimize_pose(t_se3.exp(torch.as_tensor(guess)), obs_t,
                                     convert.camera(DEFAULT_CAM))
    np.testing.assert_allclose(res_t.pose.R.numpy(), np.asarray(res_j.pose.R), atol=1e-4)
    np.testing.assert_allclose(res_t.pose.t.numpy(), np.asarray(res_j.pose.t), atol=1e-3)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 2
    assert (res_t.inlier_mask.numpy() != np.asarray(res_j.inlier_mask)).sum() <= 2
    np.testing.assert_allclose(float(res_t.chi2), float(res_j.chi2), rtol=1e-2)
    # The pose recovered is the true one (the LM converged, not just agreed).
    np.testing.assert_allclose(res_t.pose.t.numpy(), np.asarray(j_se3.exp(jnp.asarray(xi)).t),
                               atol=0.05)


@pytest.fixture(scope="module")
def tracking_state():
    """JAX system after 4 frames of the e2e scene, and frame 4's features."""
    world = SyntheticWorld(seed=3, n_points=900)
    poses = forward_trajectory(6, step=0.4)
    system = SlamSystem(DEFAULT_CAM, CFG)
    for T in poses[:4]:
        img, depth = world.render(T, DEFAULT_CAM)
        assert system.track_depth(img, depth) is not None
    img, depth = world.render(poses[4], DEFAULT_CAM)
    frame = j_frame.build_frame_jit(jnp.asarray(img), DEFAULT_CAM, CFG.orb,
                                    depth_img=jnp.asarray(depth))
    tr = system.tracker
    return tr, tr._gather_local_map(), frame


def test_track_frame_step_matches(tracking_state):
    tr, lm, frame = tracking_state
    c = tr.cfg
    args = (c.match_radius_motion, c.match_radius_local, c.min_inliers_track, c.close_depth)
    pose_j, vel_j, pi_j, pf_j = j_tracking.track_frame_step(
        tr.pose, tr.velocity, lm, frame, DEFAULT_CAM, *args,
        num_levels=c.num_levels, scale_factor=c.scale_factor,
    )
    pose_t, vel_t, pi_t, pf_t = t_tracking.track_frame_step(
        convert.se3(tr.pose), torch.as_tensor(np.array(tr.velocity)),
        convert.local_map_buffer(lm), convert.frame(frame), convert.camera(DEFAULT_CAM),
        *args, num_levels=c.num_levels, scale_factor=c.scale_factor,
    )
    pi_j, pf_j = np.asarray(pi_j), np.asarray(pf_j)
    pi_t, pf_t = pi_t.numpy(), pf_t.numpy()
    np.testing.assert_allclose(pf_t[:9], pf_j[:9], atol=1e-4)  # R
    np.testing.assert_allclose(pf_t[9:12], pf_j[9:12], atol=1e-3)  # t
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=1e-3)
    n_j = pf_j[12]
    assert n_j > 100, "the step must track"
    # n_inliers, nA, n_lidar (0), tracked_close, total_close
    assert abs(pf_t[12] - n_j) <= max(2, 0.01 * n_j)
    assert abs(pf_t[13] - pf_j[13]) <= max(2, 0.01 * pf_j[13])
    assert pf_t[14] == pf_j[14] == 0
    assert abs(pf_t[15] - pf_j[15]) <= max(2, 0.01 * pf_j[15])
    assert pf_t[16] == pf_j[16]
    valid_j = pi_j[1].astype(bool)
    assert (pi_t[1].astype(bool) != valid_j).sum() <= max(2, 0.01 * valid_j.sum())
    both = valid_j & pi_t[1].astype(bool)
    np.testing.assert_array_equal(pi_t[0][both], pi_j[0][both])
    assert (pi_t[2] != pi_j[2]).sum() <= 2  # visibility under the final pose


def test_match_and_optimize_widened_window_matches(tracking_state):
    """Stage A at twice the motion radius (the widened retry)."""
    tr, lm, frame = tracking_state
    guess_j = j_se3.retract(tr.pose, tr.velocity)
    r = 2 * tr.cfg.match_radius_motion
    pose_j, idx_j, val_j, n_j = j_tracking.match_and_optimize(guess_j, lm, frame, DEFAULT_CAM, r)
    guess_t = t_se3.retract(convert.se3(tr.pose), torch.as_tensor(np.array(tr.velocity)))
    pose_t, idx_t, val_t, n_t = t_tracking.match_and_optimize(
        guess_t, convert.local_map_buffer(lm), convert.frame(frame),
        convert.camera(DEFAULT_CAM), r)
    np.testing.assert_allclose(pose_t.t.numpy(), np.asarray(pose_j.t), atol=1e-3)
    assert abs(int(n_t) - int(n_j)) <= max(2, 0.01 * int(n_j))


def test_no_prior_fallback_marks_frame_lost(tracking_state):
    """A frame the map cannot explain goes through the no-prior recovery: the
    banks find no consensus in an empty map, nothing raises, and the tracker
    reports the frame as lost."""
    tr, lm, frame = tracking_state
    store = t_tracking.MapStore(max_keyframes=8, max_landmarks=64, feats_per_kf=600)
    tracker = t_tracking.Tracker(store, convert.camera(DEFAULT_CAM),
                                 convert.tracking_config(tr.cfg), device="cpu")
    tracker.state = t_tracking.TrackState.OK
    tracker.ref_kf = 0
    store.kf_valid[0] = True
    store.num_kf = 1
    assert tracker.track(convert.frame(frame)) is None
    assert tracker.state == t_tracking.TrackState.LOST
    assert float(tracker.velocity.abs().sum()) == 0.0 and not tracker.trajectory


def test_huber_delta_default_matches():
    assert math.isclose(t_pose_opt.optimize_pose.__defaults__[-1],
                        j_pose_opt.optimize_pose.__defaults__[-1])
