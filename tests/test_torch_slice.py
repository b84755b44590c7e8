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

        # Camera+LiDAR fusion: track_fusion on a cloud made from the depth image.
        import numpy as np
        from sqrtlm_slam_tpu_torch.lidar.features import LidarConfig
        from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackState
        cam = synthetic.DEFAULT_CAM
        R_cl = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
        lcfg = LidarConfig(num_rings=48, elev_min_deg=-30.0, elev_max_deg=30.0,
                           horizon_res_deg=0.4, ground_z=-100.0, min_range=0.5, max_range=90.0)
        cfg = SystemConfig(orb=ORBConfig(max_features=300), lidar=lcfg,
                           tracking=TrackingConfig(init_min_depth_kp=50, kf_max_interval=1))
        f = SlamSystem(cam, cfg, device="cpu")
        vs, us = np.mgrid[0:240, 0:320]
        frames = []
        for T in synthetic.forward_trajectory(8):
            img, depth = world.render(T, cam)
            z = depth.reshape(-1)
            p_c = np.stack([(us.reshape(-1) - cam.cx) * z / cam.fx,
                            (vs.reshape(-1) - cam.cy) * z / cam.fy, z], -1).astype(np.float32)
            frames.append((img, p_c @ R_cl))
        for img, cloud in frames[:7]:
            assert f.track_fusion(img, cloud, T_cam_lidar=(R_cl, np.zeros(3, np.float32))) \
                is not None
        assert f.tracker.last_lidar_matches > 0 and f.num_keyframes() == 7
        assert f.local_mapper.num_lidar_stages >= 1

        # Map resume: SlamSystem.load starts LOST and the next frame relocalises.
        import os, tempfile
        path = os.path.join(tempfile.mkdtemp(), "map.npz")
        f.save(path)
        g = SlamSystem.load(path, cam, cfg, device="cpu")
        assert g.state == TrackState.LOST and g.num_keyframes() == 7
        g.activate_localization_mode()
        img, cloud = frames[7]
        assert g.track_fusion(img, cloud, T_cam_lidar=(R_cl, np.zeros(3, np.float32))) \
            is not None
        assert g.state == TrackState.OK and g.tracker.reloc_candidates_tried >= 1
        assert g.num_keyframes() == 7

        # Stereo and monocular entries, and standalone LiDAR odometry.
        from sqrtlm_slam_tpu_torch.lidar.odometry import LidarOdometry
        st = SlamSystem(cam, SystemConfig(orb=ORBConfig(max_features=300),
                                          tracking=TrackingConfig(init_min_depth_kp=50)),
                        device="cpu")
        mono = SlamSystem(cam, SystemConfig(orb=ORBConfig(max_features=300)), device="cpu")
        for T in synthetic.forward_trajectory(2, step=0.35):
            img, _ = world.render(T, cam)
            T_r = synthetic.Pose(T.R, T.t - np.array([cam.bf / cam.fx, 0, 0], np.float32))
            st.track_stereo(img, world.render(T_r, cam)[0])
            mono.track_monocular(img)
        assert st.num_keyframes() >= 1 and mono.num_keyframes() == 2
        odo = LidarOdometry(feat_cfg=lcfg, device="cpu")
        for _, cloud in frames[:2]:
            odo.process(cloud)
        assert odo.num_keyframes >= 1 and odo.last_stats is not None

        # The runner's path: KITTI IO, the native loader, the generator,
        # long runs, plots, config, timing, the Kalman filter, calibration.
        import importlib
        for name in ("run_kitti", "io.kitti", "io.native_loader", "io.png",
                     "eval.kitti_synth", "eval.longrun", "eval.plot", "utils.config",
                     "utils.timing", "utils.kalman", "factors.calibration", "parallel",
                     "parallel.multiprocess", "parallel.mp_worker", "optim.schur",
                     "optim.edge_kernels"):
            importlib.import_module("sqrtlm_slam_tpu_torch." + name)

        # The flat backend and distributed BA over two shards.
        from sqrtlm_slam_tpu_torch.optim import facade, schur_bucketed
        from sqrtlm_slam_tpu_torch.parallel import dist_ba
        flat, _ = synthetic.make_ba_problem(seed=0, P=5, L=48, obs_per_landmark=4)
        b = schur_bucketed.from_flat(flat, 4, device="cpu")
        assert facade.Optimizer("flat").local_bundle_adjustment(b, cam)[1].shape == (48, 4)
        dist_ba.distributed_ba_lm(b, cam, dist_ba.make_mesh(2, "cpu"), num_iters=2)
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "sqrtlm_slam_tpu" or m.startswith("sqrtlm_slam_tpu.")]
        assert not loaded, loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_identity_helpers_are_always_given_their_device():
    """`se3.identity` and `sim3.identity` default to the CPU (they are
    helpers, not entry points): every call in the port, its smoke script and
    its scripts must pass `device=`, or it would silently compute on the host."""
    import ast
    import glob

    files = glob.glob(os.path.join(REPO, "sqrtlm_slam_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "scripts", "*torch*.py"))
    assert len(files) > 40
    calls = 0
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "identity"
                    and getattr(node.func.value, "id", "") in ("se3", "sim3")):
                calls += 1
                assert any(k.arg == "device" for k in node.keywords), \
                    f"{path}:{node.lineno}: identity() without device="
    assert calls >= 2


def test_all_backends_construct_and_unknown_raises():
    from sqrtlm_slam_tpu_torch.optim import facade

    assert facade.BACKENDS == ("bucketed", "flat", "cg")
    for backend in facade.BACKENDS:
        assert facade.Optimizer(backend).backend == backend
    with pytest.raises(ValueError, match="unknown backend"):
        facade.Optimizer("g2o")
