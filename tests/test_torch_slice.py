"""The ported RGB-D slice as a whole, against the JAX package.

Both `SlamSystem`s track the `test_e2e_synthetic.py` scene (seed 3, 900
points, 25 frames, step 0.4 m, 600 features) from identical images. The bars
are behavioural, because small float32 differences (the descriptor residual
of tests/test_torch_frontend.py, LM summation order) legitimately move
keyframe decisions: every frame tracked by both, keyframe counts within 1,
the port's ATE < 0.1 m, and the median per-frame distance between the two
packages' poses < 0.05 m.
"""

import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu.frontend import orb
from sqrtlm_slam_tpu.mapstore import store as j_store
from sqrtlm_slam_tpu.pipeline import SlamSystem, SystemConfig, TrackingConfig
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.mapstore import store as t_store
from sqrtlm_slam_tpu_torch.pipeline import system as t_system
from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = SystemConfig(
    orb=orb.ORBConfig(max_features=600),
    tracking=TrackingConfig(init_min_depth_kp=80, local_map_capacity=1024),
    max_keyframes=64, max_landmarks=8000,
)


@pytest.fixture(scope="module")
def runs():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        world = SyntheticWorld(seed=3, n_points=900)
        poses = forward_trajectory(25, step=0.4)
        frames = [tuple(np.array(a) for a in world.render(T, DEFAULT_CAM)) for T in poses]
        js = SlamSystem(DEFAULT_CAM, CFG)
        ts = t_system.SlamSystem(convert.camera(DEFAULT_CAM), convert.system_config(CFG),
                                 device="cpu")
        pj = [js.track_depth(img, depth) for img, depth in frames]
        pt = [ts.track_depth(img, depth) for img, depth in frames]
    finally:
        torch.set_num_threads(prev)
    gt = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = np.asarray(T.R), np.asarray(T.t)
        gt.append(np.linalg.inv(M))
    return js, ts, pj, pt, np.stack(gt)


def test_both_track_every_frame(runs):
    js, ts, pj, pt, _ = runs
    assert all(p is not None for p in pj)
    assert all(p is not None for p in pt)
    assert ts.state == TrackState.OK


def test_keyframes_and_map_agree(runs):
    js, ts, *_ = runs
    assert abs(ts.num_keyframes() - js.num_keyframes()) <= 1
    # Both attach the shipped vocabulary: every keyframe has words and BoW.
    K = ts.store.num_kf
    assert ts.store.kf_bow.shape == js.store.kf_bow.shape
    np.testing.assert_allclose(ts.store.kf_bow[:K].sum(-1), 1.0, rtol=1e-5)
    assert ((ts.store.kf_words[:K] >= 0) == ts.store.kf_kp_valid[:K]).all()
    assert ts.local_mapper.num_local_ba >= 1
    # Landmark counts follow keyframe decisions; same order of magnitude.
    assert 0.8 < ts.num_landmarks() / js.num_landmarks() < 1.25


def test_port_ate_and_pose_agreement(runs):
    js, ts, pj, pt, gt = runs
    est = ts.get_trajectory()
    assert est.shape[0] == gt.shape[0]
    ate, _ = ate_rmse(est, gt, align_scale=False)
    assert ate < 0.1, f"port ATE {ate:.3f} m"
    diffs = [np.linalg.norm(np.asarray(a.t) - b.t.numpy()) for a, b in zip(pj, pt)]
    assert np.median(diffs) < 0.05, f"median pose difference {np.median(diffs):.3f} m"


def test_trajectory_savers(runs, tmp_path):
    _, ts, *_ = runs
    kitti, tum = tmp_path / "kitti.txt", tmp_path / "tum.txt"
    ts.save_trajectory_kitti(str(kitti))
    ts.save_trajectory_tum(str(tum))
    rows = np.loadtxt(kitti)
    assert rows.shape == (25, 12)
    np.testing.assert_allclose(rows.reshape(-1, 3, 4), ts.get_trajectory()[:, :3], atol=1e-6)
    q = np.loadtxt(tum)[:, 4:]
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(ts.trajectory_frame_ids(), np.arange(25))


def test_port_mapstore_is_the_jax_packages_store():
    """The port carries the numpy MapStore so it runs without the JAX
    package; the two classes must stay identical."""
    assert inspect.getsource(t_store.MapStore) == inspect.getsource(j_store.MapStore)
    assert t_store.COVIS_THRESHOLD == j_store.COVIS_THRESHOLD


def test_main_path_imports_no_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(2)
        from sqrtlm_slam_tpu_torch.eval import synthetic
        from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
        from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
        from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig
        world = synthetic.SyntheticWorld(seed=3, n_points=900)
        s = SlamSystem(synthetic.DEFAULT_CAM, SystemConfig(
            orb=ORBConfig(max_features=300), tracking=TrackingConfig(init_min_depth_kp=50),
            loop_detection=True), device="cpu")
        assert s.vocabulary is not None and s.loop_closer is not None
        for T in synthetic.forward_trajectory(3):  # initialize, then two tracking steps
            img, depth = world.render(T, synthetic.DEFAULT_CAM)
            assert s.track_depth(img, depth) is not None
        assert (s.store.kf_words[0] >= 0).any() and s.store.kf_bow[0].sum() > 0.99
        s.loop_closer.run_global_ba()  # the loop path's global BA (K2, K3 plain versions)
        s.shutdown()
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "sqrtlm_slam_tpu" or m.startswith("sqrtlm_slam_tpu.")]
        assert not loaded, loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_unported_backends_raise():
    from sqrtlm_slam_tpu_torch.optim import facade

    facade.Optimizer("bucketed")
    facade.Optimizer("cg")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        facade.Optimizer("flat")
