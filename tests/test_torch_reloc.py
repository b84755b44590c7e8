"""Relocalisation, the no-prior recovery and map resume, against the JAX package.

PnP: both RANSAC banks on tests/test_pnp.py's scene, fed the minimal sets
that the JAX package draws (`jax.random.gumbel` + `top_k` from the same key)
through `sel`, so both packages score the same hypotheses: inlier masks equal
but for points within 1% of the chi2 gate, poses within 1e-3; and with the
port's own generator the JAX test's own bars.

`recover_pose_no_prior` runs on a frame and a local map built by the JAX
tracker (crossing through `convert`). The state machine (fallback velocity,
LOST -> relocalise, LOST -> reset, a garbage frame, localisation mode) runs in
the port alone on tests/test_robustness.py's scene. Checkpoints cross both
ways: same npz layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.algorithm import pnp as j_pnp
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu.factors.reprojection import Camera as JCamera
from sqrtlm_slam_tpu.frontend import matching as j_matching
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.geometry import so3 as j_so3
from sqrtlm_slam_tpu.mapstore import checkpoint as j_checkpoint
from sqrtlm_slam_tpu.pipeline import SlamSystem, SystemConfig, TrackingConfig
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu.pipeline import tracking as j_tracking
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.algorithm import pnp as t_pnp
from sqrtlm_slam_tpu_torch.eval import synthetic as t_synthetic
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.mapstore import checkpoint as t_checkpoint
from sqrtlm_slam_tpu_torch.pipeline import system as t_system
from sqrtlm_slam_tpu_torch.pipeline import tracking as t_tracking
from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackState

PNP_CAM = JCamera(fx=220.0, fy=220.0, cx=160.0, cy=120.0, bf=44.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------
# PnP RANSAC
# ----------------------------------------------------------------------


def pnp_scene(n=200, outlier_frac=0.3, noise=0.5):
    """tests/test_pnp.py's scene, as numpy arrays."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    X_w = jax.random.uniform(k1, (n, 3), minval=-6, maxval=6) + jnp.array([0, 0, 14.0])
    T = j_se3.SE3(j_so3.exp(jnp.array([0.1, -0.2, 0.05])), jnp.array([0.4, -0.2, 1.0]))
    x_c = j_se3.act(T, X_w)
    uv = PNP_CAM.project(x_c) + jax.random.normal(k2, (n, 2)) * noise
    n_out = int(n * outlier_frac)
    uv = uv.at[:n_out].add(jax.random.normal(k3, (n_out, 2)) * 60.0)
    return np.asarray(X_w), np.asarray(x_c), np.asarray(uv), T, n_out


def jax_minimal_sets(key, valid, k, H=256):
    """The sets `ransac_*` draw from `key` (pnp.py: gumbel, mask, top_k)."""
    g = jax.random.gumbel(key, (H, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(g, k)[1])


def _gate_margin(pose_R, pose_t, X_w, uv, is2, cam):
    """|e2 / gate - 1| per point under a pose (numpy, float64)."""
    x_c = X_w.astype(np.float64) @ np.asarray(pose_R, np.float64).T + np.asarray(pose_t)
    u = cam.fx * x_c[:, 0] / x_c[:, 2] + cam.cx
    v = cam.fy * x_c[:, 1] / x_c[:, 2] + cam.cy
    e2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * is2
    return np.abs(e2 / t_pnp.CHI2_PNP - 1.0)


def _assert_same_result(res_t, res_j, X_w, uv, cam):
    """Poses within 1e-3; inlier masks equal but for points within 1% of
    the gate."""
    np.testing.assert_allclose(res_t.pose.R.numpy(), np.asarray(res_j.pose.R), atol=1e-3)
    np.testing.assert_allclose(res_t.pose.t.numpy(), np.asarray(res_j.pose.t), atol=1e-3)
    differ = res_t.inliers.numpy() != np.asarray(res_j.inliers)
    margin = _gate_margin(res_j.pose.R, res_j.pose.t, X_w, uv, 1.0, cam)
    assert (margin[differ] < 0.01).all(), np.where(differ)[0]
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= differ.sum()


def test_ransac_pose_3d3d_matches_with_jax_minimal_sets():
    X_w, x_c, uv, _, n_out = pnp_scene()
    n = len(X_w)
    key = jax.random.PRNGKey(1)
    valid = np.ones(n, bool)
    res_j = j_pnp.ransac_pose_3d3d(key, jnp.asarray(X_w), jnp.asarray(x_c), jnp.asarray(uv),
                                   jnp.asarray(valid), jnp.ones(n), PNP_CAM)
    sel = jax_minimal_sets(key, valid, 3)
    res_t = t_pnp.ransac_pose_3d3d(torch.as_tensor(X_w), torch.as_tensor(x_c),
                                   torch.as_tensor(uv), torch.as_tensor(valid), torch.ones(n),
                                   convert.camera(PNP_CAM), sel=torch.as_tensor(sel))
    assert int(res_j.num_inliers) > n - n_out - 20
    _assert_same_result(res_t, res_j, X_w, uv, PNP_CAM)


def test_ransac_pnp_2d3d_matches_with_jax_minimal_sets():
    X_w, _, uv, _, n_out = pnp_scene()
    n = len(X_w)
    key = jax.random.PRNGKey(0)
    valid = np.ones(n, bool)
    valid[150:160] = False  # masked rows never enter a minimal set
    res_j = j_pnp.ransac_pnp_2d3d(key, jnp.asarray(X_w), jnp.asarray(uv), jnp.asarray(valid),
                                  jnp.ones(n), PNP_CAM)
    sel = jax_minimal_sets(key, valid, 6)
    assert not np.isin(sel, np.arange(150, 160)).any()
    res_t = t_pnp.ransac_pnp_2d3d(torch.as_tensor(X_w), torch.as_tensor(uv),
                                  torch.as_tensor(valid), torch.ones(n),
                                  convert.camera(PNP_CAM), sel=torch.as_tensor(sel))
    assert int(res_j.num_inliers) > n - n_out - 30
    _assert_same_result(res_t, res_j, X_w, uv, PNP_CAM)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_banks_with_own_generator_meet_the_jax_bars(seed):
    """tests/test_pnp.py's bars with minimal sets from a torch.Generator."""
    X_w, x_c, uv, T_true, n_out = pnp_scene()
    n = len(X_w)
    cam = convert.camera(PNP_CAM)
    T = convert.se3(T_true)
    g = torch.Generator().manual_seed(seed)
    ones = torch.ones(n)
    res2 = t_pnp.ransac_pnp_2d3d(torch.as_tensor(X_w), torch.as_tensor(uv), ones.bool(), ones,
                                 cam, generator=g)
    assert int(res2.num_inliers) > n - n_out - 20
    d = t_se3.local_delta(res2.pose, T)
    assert float(torch.linalg.norm(d[:3])) < 0.05
    assert float(torch.linalg.norm(d[3:])) < 0.01
    assert abs(float(torch.linalg.det(res2.pose.R)) - 1.0) < 1e-4
    X0, xc0, uv0, _, _ = pnp_scene(outlier_frac=0.0)
    res3 = t_pnp.ransac_pose_3d3d(torch.as_tensor(X0), torch.as_tensor(xc0),
                                  torch.as_tensor(uv0), ones.bool(), ones, cam, generator=g)
    d = t_se3.local_delta(res3.pose, T)
    assert float(torch.linalg.norm(d[:3])) < 0.02
    # The same seed gives the same draw.
    again = t_pnp.ransac_pnp_2d3d(torch.as_tensor(X_w), torch.as_tensor(uv), ones.bool(), ones,
                                  cam, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(again.pose.t, res2.pose.t)


def test_ransac_survives_degenerate_input():
    """No valid match at all: finite-guarded, zero inliers, no exception
    (a blank frame reaches the banks this way)."""
    n = 64
    cam = convert.camera(PNP_CAM)
    zeros = torch.zeros(n, 3)
    valid = torch.zeros(n, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    r3 = t_pnp.ransac_pose_3d3d(zeros, zeros, torch.zeros(n, 2), valid, torch.ones(n), cam,
                                generator=g)
    r2 = t_pnp.ransac_pnp_2d3d(zeros, torch.zeros(n, 2), valid, torch.ones(n), cam, generator=g)
    assert int(r3.num_inliers) == 0 and int(r2.num_inliers) == 0


# ----------------------------------------------------------------------
# recover_pose_no_prior on a JAX-built frame and local map; checkpoints
# ----------------------------------------------------------------------

J_CFG = SystemConfig(
    orb=j_orb.ORBConfig(max_features=600),
    tracking=TrackingConfig(kf_max_interval=1),  # a keyframe per frame: > 5 of them
    max_keyframes=32, max_landmarks=6000,
)
T_CFG = t_system.SystemConfig(orb=ORBConfig(max_features=600))


def _scene(n_frames, seed=2):
    """tests/test_robustness.py's scene as numpy (image, depth) pairs."""
    world = t_synthetic.SyntheticWorld(seed=seed, n_points=1000)
    poses = t_synthetic.forward_trajectory(n_frames, step=0.35)
    return poses, [world.render(T, t_synthetic.DEFAULT_CAM) for T in poses]


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    """The JAX tracker after 7 frames (7 keyframes; local mapping is left
    out, it is not what is compared here), frame 7's features, the local map
    around the last keyframe, and the map saved by the JAX package."""
    world = SyntheticWorld(seed=2, n_points=1000)
    poses = forward_trajectory(9, step=0.35)
    system = SlamSystem(DEFAULT_CAM, J_CFG)
    system.tracker.new_kf_callback = None
    for T in poses[:7]:
        assert system.track_depth(*world.render(T, DEFAULT_CAM)) is not None
    assert system.num_keyframes() == 7
    img, depth = world.render(poses[7], DEFAULT_CAM)
    frame = j_frame.build_frame_jit(jnp.asarray(img), DEFAULT_CAM, J_CFG.orb,
                                    depth_img=jnp.asarray(depth))
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_map.npz")
    system.save(path)
    return system, system.tracker._gather_local_map(), frame, path, poses


def test_recover_pose_no_prior_matches(jax_state):
    """Same matches, same minimal sets: the recovered pose within 1e-2 m /
    1e-3 (the refit's SVD and Gauss-Newton in another summation order), the
    inlier count within 3, and the pose within 0.3 m of the frame's true one
    (it is a seed for the pose LM, from keypoint depths of an 8x14 patch)."""
    system, lm, frame, _, poses = jax_state
    key = jax.random.PRNGKey(5)
    pose_j, n_j = j_tracking.recover_pose_no_prior(key, lm, frame, DEFAULT_CAM)
    res = j_matching.match_descriptors(lm.desc, frame.kp.desc, lm.valid, frame.kp.valid,
                                       max_dist=j_matching.TH_HIGH, ratio=0.9, mutual=True)
    k1, k2 = jax.random.split(key)
    valid = np.asarray(res.valid)
    ok3d = valid & (np.asarray(frame.depth)[np.asarray(res.idx)] > 0)
    pose_t, n_t = t_tracking.recover_pose_no_prior(
        convert.local_map_buffer(lm), convert.frame(frame), convert.camera(DEFAULT_CAM),
        sel3=torch.as_tensor(jax_minimal_sets(k1, ok3d, 3)),
        sel2=torch.as_tensor(jax_minimal_sets(k2, valid, 6)))
    assert int(n_j) >= 30
    assert abs(int(n_t) - int(n_j)) <= 3
    np.testing.assert_allclose(pose_t.R.numpy(), np.asarray(pose_j.R), atol=1e-3)
    np.testing.assert_allclose(pose_t.t.numpy(), np.asarray(pose_j.t), atol=1e-2)
    np.testing.assert_allclose(pose_t.t.numpy(), np.asarray(poses[7].t), atol=0.3)
    # And from the port's own generator: the same place.
    pose_g, n_g = t_tracking.recover_pose_no_prior(
        convert.local_map_buffer(lm), convert.frame(frame), convert.camera(DEFAULT_CAM),
        generator=torch.Generator().manual_seed(42))
    assert int(n_g) >= 30
    np.testing.assert_allclose(pose_g.t.numpy(), np.asarray(poses[7].t), atol=0.3)


def test_jax_checkpoint_loads_in_port_and_relocalises(jax_state):
    """`SlamSystem.load` on the JAX package's file: arrays equal, the system
    starts LOST, relocalises on the next frame near the true pose, and in
    localisation mode inserts no keyframe."""
    system, _, _, path, _ = jax_state
    poses, frames = _scene(9)
    ts = t_system.SlamSystem.load(path, t_synthetic.DEFAULT_CAM, T_CFG, device="cpu")
    for f in t_checkpoint._FIELDS:
        np.testing.assert_array_equal(getattr(ts.store, f), getattr(system.store, f), err_msg=f)
    assert ts.store.num_kf == 7 and ts.vocabulary.num_words == system.vocabulary.num_words
    np.testing.assert_array_equal(ts.vocabulary.idf.numpy(), np.asarray(system.vocabulary.idf))
    assert ts.state == TrackState.LOST
    ts.activate_localization_mode()
    pose = ts.track_depth(*frames[7])
    assert pose is not None and ts.state == TrackState.OK
    assert ts.tracker.reloc_candidates_tried >= 1
    np.testing.assert_allclose(pose.t.numpy(), poses[7].t, atol=0.1)
    assert ts.track_depth(*frames[8]) is not None
    assert ts.num_keyframes() == 7, "localisation mode must insert no keyframe"
    ts.deactivate_localization_mode()
    assert ts.tracker.localization_only is False


# ----------------------------------------------------------------------
# The state machine, in the port alone
# ----------------------------------------------------------------------


def _track(system, frames, blank=(), noise=None):
    out = []
    for i, (img, depth) in enumerate(frames):
        if i in blank:
            img, depth = np.full_like(img, 25.0), np.zeros_like(depth)
        if noise == i:
            img = (np.random.RandomState(0).rand(*img.shape) * 255).astype(np.float32)
            depth = np.zeros_like(depth)
        out.append(system.track_depth(img, depth) is not None)
    return out


@pytest.fixture(scope="module")
def occluded_run():
    """12 frames, a keyframe per frame, frames 7 and 8 blank."""
    _, frames = _scene(12)
    cfg = T_CFG._replace(tracking=t_tracking.TrackingConfig(kf_max_interval=1))
    s = t_system.SlamSystem(t_synthetic.DEFAULT_CAM, cfg, device="cpu")
    return s, _track(s, frames, blank=(7, 8)), frames


def test_occlusion_recovers_by_relocalisation(occluded_run):
    """Blank frames with > 5 keyframes -> LOST -> `_relocalize` once vision
    returns (within two frames), ending in TrackState.OK."""
    s, results, _ = occluded_run
    assert results[:7] == [True] * 7
    assert results[7] is False and results[8] is False
    assert any(results[9:11]), f"no relocalisation after the occlusion: {results}"
    assert s.state == TrackState.OK
    assert s.tracker.reloc_candidates_tried >= 1 and s.tracker.frames_lost == 0
    assert s.store.num_kf > 7  # the map was kept and grew on
    ids = s.trajectory_frame_ids()
    assert 7 not in ids and 8 not in ids and len(s.get_trajectory()) == len(ids)


def test_save_load_round_trip_in_port(occluded_run, tmp_path):
    s, _, frames = occluded_run
    path = str(tmp_path / "map.npz")
    s.save(path)
    store, voc = t_checkpoint.load_map(path, device="cpu")
    for f in t_checkpoint._FIELDS:
        np.testing.assert_array_equal(getattr(store, f), getattr(s.store, f), err_msg=f)
    assert (store.num_kf, store.num_lm) == (s.store.num_kf, s.store.num_lm)
    assert store.loop_edges == s.store.loop_edges
    for a, b in zip(voc.centroids, s.vocabulary.centroids):
        assert torch.equal(a, b)
    assert torch.equal(voc.idf, s.vocabulary.idf) and voc.k == s.vocabulary.k
    # The JAX package reads the port's file.
    j_store, j_voc = j_checkpoint.load_map(path)
    np.testing.assert_array_equal(j_store.kf_R, s.store.kf_R)
    np.testing.assert_array_equal(j_store.lm_desc, s.store.lm_desc)
    np.testing.assert_array_equal(np.asarray(j_voc.centroids[-1]),
                                  t_checkpoint.desc_to_numpy(s.vocabulary.centroids[-1]))
    # A resumed system serves no cache of another store and relocalises.
    s2 = t_system.SlamSystem.load(path, t_synthetic.DEFAULT_CAM, T_CFG, device="cpu")
    assert s2.store.version > 0 and s2.state == TrackState.LOST
    assert s2.track_depth(*frames[10]) is not None and s2.state == TrackState.OK


def test_lost_with_a_small_map_resets_and_reinitialises():
    """Lost with <= 5 keyframes: `store.reset()` and a new map from the next
    frame; no device cache of the old map is served afterwards."""
    _, frames = _scene(8)
    s = t_system.SlamSystem(t_synthetic.DEFAULT_CAM, T_CFG, device="cpu")
    results = _track(s, frames[:5], blank=(3,))
    assert results == [True, True, True, False, True]
    assert s.state == TrackState.OK and s.store.num_kf == 1
    assert len(s.tracker.trajectory) == 1 and s.tracker.trajectory[0][0] == 4
    assert s.tracker._lm_cache_key is None or s.tracker._lm_cache_key[1] <= s.store.version
    # Tracking goes on against the new map (identity at frame 4).
    assert _track(s, frames[5:7]) == [True, True]
    step = np.linalg.norm(s.get_trajectory()[1][:3, 3] - s.get_trajectory()[0][:3, 3])
    assert 0.25 < step < 0.45, step
    s.reset()
    assert s.state == TrackState.NOT_INITIALIZED and s.num_keyframes() == 0
    assert s.tracker.vocab_hook is not None and s.tracker.reloc_db is not None
    assert _track(s, frames[:2]) == [True, True]


def test_garbage_frame_does_not_poison_map():
    """One noise frame must not corrupt the map or crash
    (tests/test_robustness.py::test_garbage_frame_does_not_poison_map)."""
    _, frames = _scene(8)
    s = t_system.SlamSystem(t_synthetic.DEFAULT_CAM, T_CFG, device="cpu")
    results = _track(s, frames, noise=3)
    assert sum(results) >= 6
    assert np.isfinite(s.store.lm_pos[: s.store.num_lm]).all()
    assert np.isfinite(s.store.kf_t[: s.store.num_kf]).all()
    res = s.get_slam_result()
    assert res["state"] == s.state and len(res["kf_ids"]) == s.num_keyframes()
    assert res["map_points"].shape[0] == s.num_landmarks()
    assert res["trajectory"].shape[1:] == (4, 4) and res["num_inliers"] > 0


def test_fallback_recomputes_velocity_from_the_last_two_poses(monkeypatch):
    """A motion prediction far off the frame: stage A finds too few inliers,
    the RANSAC seed re-runs the step with zero velocity, and the velocity
    kept for the next frame is local_delta(pose, prev_pose), not the step's
    own local_delta(pose, seed)."""
    _, frames = _scene(6)
    s = t_system.SlamSystem(t_synthetic.DEFAULT_CAM, T_CFG, device="cpu")
    assert _track(s, frames[:4]) == [True] * 4
    tr = s.tracker
    prev_pose = tr.pose
    seeds = []
    real = t_tracking.recover_pose_no_prior

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seeds.append(out[0])
        return out

    monkeypatch.setattr(t_tracking, "recover_pose_no_prior", spy)
    tr.velocity = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.35, 0.0])  # a 20 degree yaw that is not there
    assert s.track_depth(*frames[4]) is not None
    assert len(seeds) == 1, "the fallback must have run"
    want = t_se3.local_delta(tr.pose, prev_pose)
    assert torch.equal(tr.velocity, want)
    in_step = t_se3.local_delta(tr.pose, seeds[0])
    assert float(torch.linalg.norm(tr.velocity[:3])) > 0.2  # one 0.35 m step
    assert float(torch.linalg.norm(tr.velocity - in_step)) > 0.1
    # The next frame tracks from that velocity without another fallback.
    assert s.track_depth(*frames[5]) is not None and len(seeds) == 1
