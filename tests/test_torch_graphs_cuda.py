"""The captured CUDA graphs of the port (`utils.cache`) on the card: every
graphed function replays its eager run bit for bit (the per-frame programs,
pipelined mode's both-radii stage A, `align_scan`, `match_and_triangulate`,
`_project_and_match` and `_project_and_match_many`, and the loop
correction's: a Gauss-Newton step of the essential graph and of the LiDAR
pose graph, and the three graphs of global BA's LM iteration), outputs survive later replays, replays count the kernels they launch,
a capture that fails raises, and two threads capture and replay at once.
Whole runs: one `align_scan` capture serves every scan of an odometry run
in its three modes, and a LiDAR odometry run and a pipelined `SlamSystem`
run equal their eager reruns; the pinned read of a step's results
(`to_host_async` + `wait_host`) gives `to_host`'s arrays. The loop
correction: `LoopCloser.run_global_ba` at the ring's size graphed equals
its eager run, called directly and on its own thread
(`async_gba`); two graphs holding K3, captured on one stream, replay at
once on two threads' streams as they do alone; device memory after three
loop closures of different shapes stays within one capture per program of
its level after the first, and a `max_entries=1` program recaptured at
eight growing shapes holds about one capture's memory without any
`empty_cache` of the test's. Relocalisation and the loop's Sim3
verification (`recover_pose_no_prior` and `ransac_sim3` through their
public names, drawing from a generator outside the graph; `optimize_sim3`
with fixed and free scale; `project_match` on the loop group padded to
`loop_points_cap`; `guided_sim3_match`): a capture and a replay equal two
eager calls bit for bit, the second call of a shape replays without
capturing, and a graphed call leaves the generator where the eager call
leaves it. The monocular initializer (one graph, its uniforms drawn
outside), the flat engine's LM loop (local and global BA's captures) and
its three PCG graphs, the cg backend's local-BA graphs and the calibration
(with and without plane terms) replay their eager runs bit for bit and
capture once a shape; RGB-D runs with the flat and the cg local BA, and a
monocular run, equal their eager reruns. Distributed BA: the whole LM loop
over 1, 2 and 4 shards on one card, the bucketed and flat steps and every
segment graph replay their eager runs bit for bit and capture once a
shape; the whole loop launches one graph a call and equals the segments'
replays; K2 / K3 launch D x iters / D x (iters + 1) times in a replayed
call; two `mp_worker` ranks with gloo on one card give equal digests, each
equal to its own eager rerun.

Marked `cuda`: each test skips where no CUDA device exists. The file
imports neither JAX nor the JAX package (the card has no JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py -m cuda -q

The CPU side of the same functions, against the JAX package:
tests/test_torch_graphs.py.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu_torch import utils
from sqrtlm_slam_tpu_torch.eval import graph_calls, planeworld, scale, synthetic, verification
from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.geometry import se3, sim3
from sqrtlm_slam_tpu_torch.lidar import backend
from sqrtlm_slam_tpu_torch.lidar import features as lidar_features
from sqrtlm_slam_tpu_torch.lidar import odometry
from sqrtlm_slam_tpu_torch.loop import closing, essential_graph, sim3_solver
from sqrtlm_slam_tpu_torch.ops import hamming
from sqrtlm_slam_tpu_torch.optim import assembly, facade, schur, schur_bucketed
from sqrtlm_slam_tpu_torch.parallel import dist_ba
from sqrtlm_slam_tpu_torch.pipeline import frame as frame_mod
from sqrtlm_slam_tpu_torch.pipeline import initializer, local_mapping, tracking, triangulation
from sqrtlm_slam_tpu_torch.pipeline.local_mapping import LocalMappingConfig
from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig
from sqrtlm_slam_tpu_torch.utils import cache

pytestmark = pytest.mark.cuda

CAM = synthetic.DEFAULT_CAM
ORB = ORBConfig(max_features=600)
LCFG = lidar_features.LidarConfig(num_rings=32, horizon_res_deg=0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same_bits(a, b) -> bool:
    """Bitwise equality of two outputs (NaN bits compare equal)."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            return False
        if a.is_floating_point():
            ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    return a == b


def _perturbed(x):
    """The same nest with every float tensor scaled by 1 + 1e-4."""
    if isinstance(x, torch.Tensor):
        return x * (1.0 + 1e-4) if x.is_floating_point() else x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_perturbed(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_perturbed(v) for v in x)
    return x


def _scans(n: int, first: int = 0):
    """Scans (sensor frame, rays on LCFG's columns) of the small street."""
    world = planeworld.street_circuit_world(seed=0, A=12.0, B=8.0, half_width=4.0, texel=0.05,
                                            panel_spacing=6.0)
    poses, _ = planeworld.circuit_trajectory(first + n, A=12.0, B=8.0, corner_r=3.0, step=0.5)
    out = []
    for i in range(first, first + n):
        raw = world.lidar_scan(poses[i], planeworld.T_CAM_VELO, n_rings=32, n_azimuth=720,
                               noise_seed=i)
        out.append(planeworld.center_scan_on_columns(raw, planeworld.T_CAM_VELO, 0.5)[0])
    return out


def _scan():
    return _scans(1, first=3)[0]


def _programs(dev):
    """(name, graphed function, args, kwargs) of every captured program, on
    `dev`."""
    world = synthetic.SyntheticWorld(seed=3, n_points=900)
    T0 = synthetic.forward_trajectory(25, step=0.4)[12]
    img, depth = (torch.as_tensor(a, device=dev) for a in world.render(T0, CAM))
    wide = CAM._replace(bf=220.0)
    T_r = synthetic.Pose(T0.R, T0.t - np.array([wide.bf / wide.fx, 0, 0], np.float32))
    left = torch.as_tensor(world.render(T0, wide)[0], device=dev)
    right = torch.as_tensor(world.render(T_r, wide)[0], device=dev)
    cloud = torch.as_tensor(lidar_features.pad_cloud(_scan()), device=dev)
    R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    f0 = frame_mod.build_frame(img, CAM, ORB, depth_img=depth)
    z = f0.depth
    pos = torch.stack([(f0.kp.xy[:, 0] - CAM.cx) * z / CAM.fx,
                       (f0.kp.xy[:, 1] - CAM.cy) * z / CAM.fy, z], -1) + 0.01
    lm = tracking.LocalMapBuffer(ids=None, pos=pos, desc=f0.kp.desc,
                                 valid=(z > 0) & f0.kp.valid,
                                 max_dist=torch.full_like(z, float("inf")))
    feat = lidar_features.extract_features(cloud, LCFG)
    rng = np.random.RandomState(0)
    pts = torch.as_tensor(rng.uniform(-10, 10, (512, 3)).astype(np.float32), device=dev)
    nrm = torch.nn.functional.normalize(
        torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32), device=dev), dim=-1)
    ok = torch.ones(512, dtype=torch.bool, device=dev)
    lidar_map = odometry.build_local_map(pts, ok, pts.flip(0), ok, nrm, odometry.OdomConfig())
    pose = tracking.se3.identity(device=dev)
    vel = torch.zeros(6, device=dev)
    pose_a, _, _, n_a = tracking._stage_a(pose, vel, lm, f0, CAM, 15.0)
    flat, _ = synthetic.make_ba_problem(seed=1, P=32, L=1024, stereo_frac=0.6,
                                        obs_per_landmark=4)
    problem = schur_bucketed.from_flat(flat, 8, device=dev)
    # Local mapping's inputs: frame 0 against the frame 0.4 m further on.
    T1 = synthetic.forward_trajectory(25, step=0.4)[13]
    img1, depth1 = (torch.as_tensor(a, device=dev) for a in world.render(T1, CAM))
    f1 = frame_mod.build_frame(img1, CAM, ORB, depth_img=depth1)
    pose0 = tracking.se3.SE3(torch.as_tensor(T0.R, device=dev), torch.as_tensor(T0.t, device=dev))
    pose1 = tracking.se3.SE3(torch.as_tensor(T1.R, device=dev), torch.as_tensor(T1.t, device=dev))

    def sigma2(kp):
        return torch.pow(1.2, 2.0 * kp.octave.to(torch.float32))

    tri = (pose0, pose1, CAM, f0.kp.xy, f0.kp.desc, f0.kp.valid, sigma2(f0.kp), f1.kp.xy,
           f1.kp.desc, f1.kp.valid, sigma2(f1.kp))
    M = 4096  # fuse_cap
    world_pos = tracking.se3.act(tracking.se3.inverse(pose0), pos)
    n = world_pos.shape[0]
    lms = [torch.zeros(M, 3, device=dev), torch.zeros(M, 8, dtype=torch.int32, device=dev),
           torch.zeros(M, dtype=torch.bool, device=dev), torch.zeros(M, 3, device=dev),
           torch.zeros(M, device=dev), torch.full((M,), float("inf"), device=dev)]
    lms[0][:n], lms[1][:n], lms[2][:n] = world_pos, f0.kp.desc, lm.valid
    lms[3][:n] = torch.nn.functional.normalize(world_pos - pose0.t, dim=-1)
    B = local_mapping.FUSE_BATCH
    many = (torch.eye(3, device=dev).repeat(B, 1, 1), torch.zeros(B, 3, device=dev),
            *lms, f1.kp.xy.repeat(B, 1, 1), f1.kp.desc.repeat(B, 1, 1),
            torch.zeros(B, f1.kp.valid.shape[0], dtype=torch.bool, device=dev))
    many[0][:2], many[1][:2] = torch.stack([pose1.R, pose0.R]), torch.stack([pose1.t, pose0.t])
    many[-1][:2] = torch.stack([f1.kp.valid, f0.kp.valid])
    return [
        ("build_frame_rgbd", frame_mod.build_frame_jit, (img, CAM, ORB), dict(depth_img=depth)),
        ("build_frame_mono", frame_mod.build_frame_jit, (img, CAM, ORB), {}),
        ("build_frame_fusion", frame_mod.build_frame_jit, (img, CAM, ORB),
         dict(cloud_lidar=cloud, T_cam_lidar=(R, t), lidar_cfg=LCFG)),
        ("build_frame_stereo", frame_mod.build_frame_stereo_jit, (left, right, wide, ORB), {}),
        ("extract_features", lidar_features.extract_features_jit, (cloud, LCFG), {}),
        ("stage_a", tracking._stage_a_jit, (pose, vel, lm, f0, CAM, 15.0), {}),
        ("stages_bc", tracking._stages_bc_jit, (pose, pose_a, n_a, lm, f0, CAM, 7.0, 40.0), {}),
        ("stages_bc_fused", tracking._stages_bc_jit,
         (pose, pose_a, n_a, lm, f0._replace(lidar=feat), CAM, 7.0, 40.0, lidar_map), {}),
        ("local_ba", local_mapping._bucketed_local_ba_jit, (problem, CAM), {}),
        ("stage_a_both", tracking._stage_a_both_jit, (pose, vel, lm, f0, CAM, 15.0, 10), {}),
        ("align_scan", odometry.align_scan, (pose, feat.sharp, feat.sharp_valid, feat.flat,
                                             feat.flat_valid, lidar_map, odometry.OdomConfig()),
         dict(dof_mask=odometry.DOF_PRESETS["z_rot_xy_trans"])),
        ("match_and_triangulate", triangulation.match_and_triangulate, tri,
         dict(angles1=f0.kp.angle, angles2=f1.kp.angle)),
        ("project_and_match", local_mapping._project_and_match,
         (pose1.R, pose1.t, *lms, f1.kp.xy, f1.kp.desc, f1.kp.valid, CAM, 3.0), {}),
        ("project_and_match_many", local_mapping._project_and_match_many, many + (CAM, 3.0),
         {}),
        ("odometry_retract", odometry._retract_jit, (pose_a, torch.full((6,), 0.01, device=dev)),
         {}),
        ("odometry_local_delta", odometry._local_delta_jit, (pose_a, pose), {}),
    ] + _loop_programs(dev)


def _ring_store(n_kf, n_lm, seed=0):
    """tests/test_torch_gba.py's drifted ring store at `n_kf` keyframes, the
    ring's radius cut with it (the 600-keyframe step)."""
    store, _, _ = scale.make_scale_store(n_kf=n_kf, n_lm=n_lm, obs_per_lm=5, drift=4e-4,
                                         radius=80.0 * n_kf / 600, seed=seed)
    return store


def _pose_graph(store, dev):
    """The essential graph of a loop from the store's last keyframe to its
    first, as `LoopCloser.correct_loop` builds it."""
    K = store.num_kf
    lc = closing.LoopCloser(store, CAM, device=dev)
    ones = np.ones(K, np.float32)
    R, t = store.kf_R[:K].copy(), store.kf_t[:K].copy()
    S12 = sim3.Sim3(torch.tensor(1.0), torch.eye(3), torch.zeros(3))
    return lc._build_pose_graph(K - 1, 0, S12, ones, R, t, ones.copy(), R.copy(), t.copy())


def _chain_graph(n, dev, seed=0):
    rng = np.random.RandomState(seed)
    chain = [se3.SE3(torch.eye(3, device=dev),
                     torch.as_tensor(rng.normal(size=3).astype(np.float32), device=dev))
             for _ in range(n)]
    return backend.build_chain_graph(chain, [(0, n - 1, chain[3])], anchors=[(4, np.ones(3))])


def _loop_programs(dev):
    """The loop correction's graphs on ring-sized inputs: a Gauss-Newton step
    of the essential graph and of the LiDAR pose graph, and the three graphs
    of global BA's LM iteration."""
    store = _ring_store(69, 6000)
    prob, _ = closing.gather_global_problem_bucketed(store, dev)
    act, plan = prob.obs_valid, schur_bucketed.pose_plan(prob, prob.obs_valid)
    mu = torch.full((), 1e-3, device=dev)
    nu = torch.full((), 2.0, device=dev)
    chi2 = schur_bucketed.chi2_only(prob, CAM, act, 2.447)
    head = schur_bucketed._cg_head(prob, act, mu, plan, CAM, 2.447, 1e-2)
    lm = dict(cam=CAM, robust_delta=2.447)

    pg = _pose_graph(store, dev)
    g = _chain_graph(28, dev)
    return [
        ("essential_graph_step", essential_graph._gn_step_jit,
         (pg, *essential_graph._step_plans(pg), 1e-6), {}),
        ("gba_cg_head", schur_bucketed._cg_head_jit, (prob, act, mu, plan), dict(lm, tol=1e-2)),
        ("gba_pcg_chunk", schur_bucketed._pcg_chunk_jit,
         (head.ctx, head.Mp, prob.obs_cam, prob.pose_fixed, plan, head.pcg), dict(steps=10)),
        ("gba_lm_tail", schur_bucketed._lm_tail_jit,
         (prob, head.ctx, head.pcg.x, chi2, mu, nu, act), lm),
        ("se3_graph_step", backend._gn_step_jit, (g, *backend._step_plans(g), 1e-6), {}),
    ]


NAMES = ["build_frame_rgbd", "build_frame_mono", "build_frame_fusion", "build_frame_stereo",
         "extract_features", "stage_a", "stages_bc", "stages_bc_fused", "local_ba",
         "stage_a_both", "align_scan", "match_and_triangulate", "project_and_match",
         "project_and_match_many", "odometry_retract", "odometry_local_delta",
         "essential_graph_step", "gba_cg_head", "gba_pcg_chunk", "gba_lm_tail",
         "se3_graph_step"]


@pytest.mark.parametrize("which", NAMES)
def test_replay_equals_eager_bit_for_bit(cuda_device, which):
    name, fn, args, kwargs = next(p for p in _programs(cuda_device) if p[0] == which)
    args_b, kwargs_b = _perturbed(args), _perturbed(kwargs)
    with cache.disable_graphs():
        want_a = fn(*args, **kwargs)
        want_b = fn(*args_b, **kwargs_b)
    captures = utils.graph_captures
    got_a = fn(*args, **kwargs)  # capture, then the first replay
    got_b = fn(*args_b, **kwargs_b)  # a replay on other values
    again_a = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert utils.graph_captures <= captures + 1
    assert _same_bits(got_a, want_a), name
    assert _same_bits(got_b, want_b), name
    assert _same_bits(again_a, want_a), name


def test_outputs_survive_later_replays(cuda_device):
    name, fn, args, kwargs = _programs(cuda_device)[0]
    first = fn(*args, **kwargs)
    kept = [t.clone() for t in first.kp + (first.uvr, first.depth)]
    second = fn(*_perturbed(args), **_perturbed(kwargs))
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept, first.kp + (first.uvr, first.depth)))
    assert not torch.equal(first.uvr, second.uvr)  # the replays did run on other values


def test_replays_count_the_kernels_they_launch(cuda_device):
    programs = {p[0]: p for p in _programs(cuda_device)}
    for name, counter in (("stage_a", (hamming, "launch_count")),
                          ("local_ba", (assembly, "launch_count"))):
        _, fn, args, kwargs = programs[name]
        mod, attr = counter
        fn(*args, **kwargs)  # captured by now
        with cache.disable_graphs():
            c0 = getattr(mod, attr)
            fn(*args, **kwargs)
            eager = getattr(mod, attr) - c0
        c0, r0 = getattr(mod, attr), utils.graph_replays
        for _ in range(3):
            fn(*args, **kwargs)
        assert eager > 0 and getattr(mod, attr) - c0 == 3 * eager, name
        assert utils.graph_replays - r0 == 3


def test_a_capture_that_fails_raises(cuda_device):
    reads_host = cache.graphed(lambda x: x * float(x.sum()))
    moves_to_host = cache.graphed(lambda x: x.cpu() + 1)
    x = torch.ones(8, device=cuda_device)
    for fn in (reads_host, moves_to_host):
        with pytest.raises(RuntimeError):
            fn(x)
        assert fn.num_entries() == 0
    # The stream and the allocator are usable afterwards.
    ok = cache.graphed(lambda x: x * 2)
    assert torch.equal(ok(x), x * 2)


def test_two_threads_capture_and_replay_at_once(cuda_device):
    """A tracking-like thread (frame builds) and a mapping-like thread (local
    BA) capture and replay new keys at the same time; every result equals
    the eager run of the same inputs."""
    progs = {p[0]: p for p in _programs(cuda_device)}
    _, build, b_args, b_kw = progs["build_frame_mono"]
    img = b_args[0]
    orb = ORBConfig(max_features=512)  # keys no other test captured
    flat, _ = synthetic.make_ba_problem(seed=2, P=32, L=768, stereo_frac=0.6, obs_per_landmark=4)
    prob = schur_bucketed.from_flat(flat, 6, device=cuda_device)
    ba = local_mapping._bucketed_local_ba_jit
    with cache.disable_graphs():
        want_f = [build(img * s, CAM, orb) for s in (1.0, 0.99)]
        want_b = [ba(_perturbed(prob) if i else prob, CAM) for i in range(2)]
    got, errors = {}, []
    barrier = threading.Barrier(2)

    def tracker():
        try:
            barrier.wait(timeout=60)
            got["f"] = [build(img * s, CAM, orb) for s in (1.0, 0.99, 1.0, 0.99)]
        except Exception as e:  # reported in the main thread
            errors.append(e)

    def mapper():
        try:
            barrier.wait(timeout=60)
            got["b"] = [ba(_perturbed(prob) if i % 2 else prob, CAM) for i in range(4)]
        except Exception as e:  # reported in the main thread
            errors.append(e)

    threads = [threading.Thread(target=tracker), threading.Thread(target=mapper)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    torch.cuda.synchronize()
    for i, out in enumerate(got["f"]):
        assert _same_bits(out, want_f[i % 2])
    for i, out in enumerate(got["b"]):
        assert _same_bits(out, want_b[i % 2])


def _rgbd_frames(n=12):
    world = synthetic.SyntheticWorld(seed=1, n_points=1200)
    poses = synthetic.forward_trajectory(n, step=0.3)
    return poses, [world.render(T, CAM) for T in poses]


def test_graphed_system_equals_the_eager_system_and_async_mapping_tracks(cuda_device):
    """`track_depth` over 12 frames graphed and eagerly: trajectories and
    maps bitwise equal. Then asynchronous mapping with a local-BA shape no
    other run captured, so the worker captures while the tracking thread
    replays: every frame tracked, ATE < 0.05 m."""
    poses, frames = _rgbd_frames()
    cfg = SystemConfig(orb=ORBConfig(max_features=1000))
    runs = []
    for eager in (False, True):
        s = SlamSystem(CAM, cfg, device=cuda_device)
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            tracked = sum(s.track_depth(*f) is not None for f in frames)
        assert tracked == len(frames) and s.local_mapper.num_local_ba >= 1
        runs.append((s.get_trajectory(), s.store.kf_R.copy(), s.store.kf_t.copy(),
                     s.store.lm_pos.copy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)

    acfg = cfg._replace(async_mapping=True,
                        local_mapping=LocalMappingConfig(point_cap=3584))
    captures = utils.graph_captures
    s = SlamSystem(CAM, acfg, device=cuda_device)
    tracked = sum(s.track_depth(*f) is not None for f in frames)
    s.shutdown()
    assert tracked == len(frames) and s.local_mapper.num_local_ba >= 1
    assert utils.graph_captures > captures
    gt = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = T.R, T.t
        gt.append(np.linalg.inv(M))
    ate, _ = ate_rmse(s.get_trajectory(), np.stack(gt), align_scale=False)
    assert ate < 0.05, ate



def _odometry_run(dev, scans, cfg):
    """`LidarOdometry.process` over `scans` in `slam` mode, then the last
    scans again in `mapping` and `localization` modes (the slam run's map as
    the prior): the poses of the three runs."""
    poses = []
    slam = odometry.LidarOdometry(cfg, feat_cfg=LCFG, device=dev)
    poses += [slam.process(p) for p in scans]
    mapping = odometry.LidarOdometry(cfg, feat_cfg=LCFG, device=dev)
    mapping.mode = "mapping"
    poses += [mapping.process(p) for p in scans[:4]]
    loc = odometry.LidarOdometry(cfg, feat_cfg=LCFG, device=dev)
    lm = slam._local_map
    loc._local_map, loc.mode = lm, "localization"
    poses += [loc.process(p) for p in scans[4:]]
    assert slam.num_keyframes >= 2
    return poses


def test_one_align_scan_capture_serves_every_scan_and_equals_the_eager_run(cuda_device):
    """A fresh `OdomConfig` (a new key): one capture for every scan of the
    three modes, one replay a scan after each mode's first, and the graphed
    poses bitwise equal to the eager run's."""
    scans = _scans(8)
    cfg = odometry.OdomConfig(damping=1.25e-4, kf_dist=1.0)
    entries, replays = odometry.align_scan.num_entries(), utils.graph_replays
    graphed = _odometry_run(cuda_device, scans, cfg)
    torch.cuda.synchronize()
    assert odometry.align_scan.num_entries() == entries + 1
    with cache.disable_graphs():
        eager = _odometry_run(cuda_device, scans, cfg)
    for a, b in zip(graphed, eager):
        assert _same_bits((a.R, a.t), (b.R, b.t))
    assert utils.graph_replays > replays + len(scans)


def test_pipelined_system_graphed_equals_eager(cuda_device):
    """12 RGB-D frames with pipelined tracking (the both-radii stage A, the
    pinned read), graphed and eager: every frame tracked, trajectories and
    maps bitwise equal."""
    poses, frames = _rgbd_frames()
    cfg = SystemConfig(orb=ORBConfig(max_features=1000),
                       tracking=TrackingConfig(pipelined=True))
    runs = []
    for eager in (False, True):
        s = SlamSystem(CAM, cfg, device=cuda_device)
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            tracked = sum(s.track_depth(*f) is not None for f in frames)
            runs.append((s.get_trajectory(), s.store.kf_R.copy(), s.store.kf_t.copy(),
                         s.store.lm_pos.copy()))
        assert tracked == len(frames) and s.tracker.cfg.pipelined
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_the_pinned_read_equals_to_host(cuda_device):
    """`to_host_async` + `wait_host` (the step's read) gives `to_host`'s
    arrays, one counted read each, also with work queued after the copy."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    packed_i = torch.randint(-5, 2000, (3, 2048), dtype=torch.int32, device=cuda_device,
                             generator=g)
    packed_f = torch.randn(17, device=cuda_device, generator=g)
    want = utils.to_host(packed_i, packed_f)
    r0 = utils.host_reads
    copy = utils.to_host_async(packed_i, packed_f)
    big = torch.randn(4096, 4096, device=cuda_device, generator=g)
    for _ in range(8):  # queued after the copy; the read does not wait for it
        big = big @ big * 1e-3
    got = utils.wait_host(copy)
    assert utils.host_reads == r0 + 1
    assert all(isinstance(a, np.ndarray) for a in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert copy.tensors[0].is_pinned()
    torch.cuda.synchronize()


def _store_state(store):
    return [getattr(store, f).copy() for f in ("kf_R", "kf_t", "lm_pos", "lm_obs_kf")]


@pytest.mark.parametrize("mode", ["sync", "async_gba"])
def test_loop_closer_gba_graphed_equals_eager(cuda_device, mode):
    """`run_global_ba` (20 LM iterations in chunks of 5) on a 69-keyframe
    ring store (the ring run's size at its loop): graphed, its map is the
    eager run's bit for bit; K2 and K3 launch once per LM iteration inside
    the graphs, as eagerly (plus once each in a capture's eager warm-up)."""
    runs = []
    captures = utils.graph_captures
    for eager in (False, True):
        store = _ring_store(69, 17000)
        lc = closing.LoopCloser(store, CAM, device=cuda_device)
        c2, c3 = assembly.launch_count, assembly.chi2_launch_count
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            if mode == "sync":
                assert lc.run_global_ba() is True
            else:
                lc.async_gba = True
                lc._gba_thread = threading.Thread(target=lc.run_global_ba,
                                                  args=(lc.gba_generation,), daemon=True)
                lc._gba_thread.start()
                lc.wait_gba()
                assert lc.num_gba_completed == 1
        torch.cuda.synchronize()
        runs.append((_store_state(store), assembly.launch_count - c2,
                     assembly.chi2_launch_count - c3))
    (graphed, k2_g, k3_g), (eager, k2_e, k3_e) = runs
    for a, b in zip(graphed, eager):
        np.testing.assert_array_equal(a, b)
    warm_ups = int(utils.graph_captures > captures)  # K2 and K3 sit in one graph each
    assert k2_e == 20 and k3_e == 24 and k2_g == 20 + warm_ups and k3_g == 24 + warm_ups


def test_two_threads_replay_graphs_holding_k3_at_once(cuda_device):
    """Two captures of global BA's last graph (K3 at the candidate inside),
    made on one stream, replayed together from two threads on two streams:
    each gives what it gives alone, every time. A graph cache of its own,
    without `_lm_tail_jit`'s bound of one capture."""
    fn = cache.graphed(schur_bucketed._lm_tail, static_argnames=("cam", "robust_delta"))
    calls, want = [], []
    for n_kf, n_lm in ((48, 3000), (60, 4000)):
        prob, _ = closing.gather_global_problem_bucketed(_ring_store(n_kf, n_lm), cuda_device)
        act, plan = prob.obs_valid, schur_bucketed.pose_plan(prob, prob.obs_valid)
        chi2 = schur_bucketed.chi2_only(prob, CAM, act, 2.447)
        mu = torch.full((), 1e-3, device=cuda_device)
        head = schur_bucketed._cg_head(prob, act, mu, plan, CAM, 2.447, 1e-2)
        args = (prob, head.ctx, head.pcg.p, chi2, mu, torch.full((), 2.0, device=cuda_device),
                act)
        kw = dict(cam=CAM, robust_delta=2.447)
        with cache.disable_graphs():
            want.append(fn(*args, **kw))
        fn(*args, **kw)  # captured here, on this thread's capture stream
        calls.append((args, kw))
    torch.cuda.synchronize()
    got, errors = {0: [], 1: []}, []
    barrier = threading.Barrier(2)

    def replayer(i):
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            barrier.wait(timeout=60)
            with torch.cuda.stream(stream):
                for _ in range(20):
                    got[i].append(fn(*calls[i][0], **calls[i][1]))
            stream.synchronize()
        except Exception as e:  # reported in the main thread
            errors.append(e)

    threads = [threading.Thread(target=replayer, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in (0, 1):
        assert len(got[i]) == 20
        for out in got[i]:
            assert _same_bits(out, want[i])


def test_memory_stays_within_one_capture_per_program_over_three_closures(cuda_device):
    """Three loop closures of different shapes (essential graph, global BA,
    the LiDAR pose graph): the device memory kept after the third is within
    one capture per program of the memory kept after the first (memory
    reserved after `empty_cache`)."""
    programs = [essential_graph._gn_step_jit, backend._gn_step_jit,
                schur_bucketed._cg_head_jit, schur_bucketed._pcg_chunk_jit,
                schur_bucketed._lm_tail_jit]
    for fn in programs:
        fn._entries.clear()  # earlier tests' captures

    def kept():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(cuda_device)

    def closure(n_kf, n_lm, n_chain):
        store = _ring_store(n_kf, n_lm)
        essential_graph.optimize_pose_graph(_pose_graph(store, cuda_device), num_iters=3)
        lc = closing.LoopCloser(store, CAM, cfg=closing.LoopClosingConfig(gba_iters=2,
                                                                         gba_chunk=2),
                                device=cuda_device)
        assert lc.run_global_ba() is True
        backend.optimize_se3_graph(_chain_graph(n_chain, cuda_device), num_iters=3)

    r0 = kept()
    closure(72, 12000, 30)
    r1 = kept()
    closure(60, 10000, 26)
    closure(66, 11000, 28)
    r3 = kept()
    assert r1 > r0
    assert r3 - r1 <= r1 - r0, (r0, r1, r3)
    assert all(fn.num_entries() <= fn.max_entries for fn in programs)


def test_recaptures_at_growing_shapes_keep_reserved_memory_flat(cuda_device):
    """A `max_entries=1` program recaptured at eight growing shapes (as the
    loop correction's programs are, once a correction) holds about one
    capture's memory as the run holds it: the test never empties the
    allocator's cache, so a dropped graph's pool that stayed cached would
    add its ~200 MB at every recapture."""

    def body(x):
        y = x * 2.0
        z = y + 1.0
        return (z * y).sum(0)

    fn = cache.graphed(body, max_entries=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(cuda_device)
    held = []
    for i in range(8):
        x = torch.rand(16384 + 512 * i, 1024, device=cuda_device)  # 64 MB, +2 MB a step
        out = fn(x)
        assert torch.equal(out, body(x))
        del x, out
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_reserved(cuda_device) - base)
    assert fn.captures == 8 and fn.num_entries() == 1
    assert max(held) <= 2 * held[0], [h / 2**20 for h in held]


def _verification_programs(dev):
    """name -> (graphed function, call(variant) -> (outputs, generator state
    or None)) of relocalisation and the Sim3 verification on `dev`, on
    `eval/verification.py`'s inputs. The variant is a generator seed where
    the entry point draws, else 0 (the inputs) or 1 (the inputs scaled by
    1 + 1e-4)."""
    world = synthetic.SyntheticWorld(seed=3, n_points=900)
    T0 = synthetic.forward_trajectory(25, step=0.4)[12]
    img, depth = (torch.as_tensor(a, device=dev) for a in world.render(T0, CAM))
    f0 = frame_mod.build_frame(img, CAM, ORB, depth_img=depth)
    calls = verification.verification_calls(f0, CAM, torch.Generator(device=dev).manual_seed(0))
    pos, desc, valid = calls["_recover_pose_jit"][1][:3]
    lm = tracking.LocalMapBuffer(ids=None, pos=pos, desc=desc, valid=valid,
                                 max_dist=torch.full_like(pos[:, 0], float("inf")))
    x1, x2, matched, is2 = calls["_ransac_sim3_jit"][1][:4]

    def drawn(fn):
        def call(seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            return fn(g), g.get_state()
        return call

    def plain(name, **override):
        fn, args, kwargs = calls[name]
        kwargs = dict(kwargs, **override)

        def call(variant):
            a, k = (args, kwargs) if variant == 0 else (_perturbed(args), _perturbed(kwargs))
            return fn(*a, **k), None
        return fn, call

    return {
        "recover_pose_no_prior": (tracking._recover_pose_jit, drawn(
            lambda g: tracking.recover_pose_no_prior(lm, f0, CAM, generator=g))),
        "ransac_sim3": (sim3_solver._ransac_sim3_jit, drawn(
            lambda g: sim3_solver.ransac_sim3(x1, x2, matched, is2, is2, CAM, fix_scale=False,
                                              generator=g))),
        "optimize_sim3": plain("optimize_sim3", fix_scale=False),
        "optimize_sim3_fixed_scale": plain("optimize_sim3", fix_scale=True),
        "project_match": plain("project_match"),
        "guided_sim3_match": plain("guided_sim3_match"),
    }


@pytest.mark.parametrize("which", ["recover_pose_no_prior", "ransac_sim3", "optimize_sim3",
                                   "optimize_sim3_fixed_scale", "project_match",
                                   "guided_sim3_match"])
def test_verification_graphs_replay_eager_bits_and_capture_once(cuda_device, which):
    graphed, call = _verification_programs(cuda_device)[which]
    with cache.disable_graphs():
        want = [call(v) for v in (0, 1)]
    c0, r0 = utils.graph_captures, utils.graph_replays
    got0 = call(0)  # a capture (unless an earlier test made it), then a replay
    c1 = utils.graph_captures
    got1 = call(1)  # the same shape: a replay only
    torch.cuda.synchronize()
    assert c1 - c0 <= 1 and graphed.num_entries() >= 1
    assert utils.graph_captures == c1 and utils.graph_replays == r0 + 2
    for (out, state), (out_want, state_want) in zip((got0, got1), want):
        assert _same_bits(out, out_want), which
        if state is not None:  # the graphed call drew what the eager call drew
            assert torch.equal(state, state_want), which


def _init_and_ba_programs(dev):
    """name -> (graphed function, call(variant) -> outputs) of the monocular
    initializer (2000 matches; the variant seeds the uniforms' generator),
    the flat engine's and the cg backend's local-BA graphs and the flat
    global loop (P, L, K = 32, 2048, 5) and the calibration with and
    without plane terms (variant 1: the inputs scaled by 1 + 1e-4), on
    `eval/graph_calls.py`'s inputs."""
    xy1, xy2, valid = graph_calls.two_view_matches(2000, CAM, dev)

    def initialize(seed):
        fn, a, k = graph_calls.init_calls(xy1, xy2, valid, CAM,
                                          torch.Generator(device=dev).manual_seed(seed))[
            "_initialize_jit"]
        return fn(*a, **k)

    flat, _ = synthetic.make_ba_problem(seed=5, P=32, L=2048, stereo_frac=0.6,
                                        obs_per_landmark=5)
    calls = graph_calls.ba_calls(schur_bucketed.from_flat(flat, 5, device=dev), CAM)
    rng = np.random.RandomState(2)
    T_true = se3.exp(torch.as_tensor(rng.normal(size=6).astype(np.float32) * 0.1,
                                     device=dev))
    p_l = torch.as_tensor(rng.normal(size=(2048, 3)).astype(np.float32) * 5.0, device=dev)
    calls.update(graph_calls.calibration_calls(p_l, T_true))

    def plain(name):
        fn, args, kwargs = calls[name]

        def call(variant):
            a, k = (args, kwargs) if variant == 0 else (_perturbed(args), _perturbed(kwargs))
            return fn(*a, **k)
        return fn, call

    out = {name: plain(name) for name in calls}
    out["initialize"] = (initializer._initialize_jit, initialize)
    return out


INIT_BA_NAMES = ["initialize", "flat_local_loop", "flat_global_loop", "flat_cg_head",
                 "flat_pcg_chunk", "flat_lm_tail", "local_cg_head", "local_pcg_chunk",
                 "local_lm_tail", "calibrate_extrinsics", "calibrate_extrinsics_pairs"]


@pytest.mark.parametrize("which", INIT_BA_NAMES)
def test_init_and_ba_graphs_replay_eager_bits_and_capture_once(cuda_device, which):
    graphed, call = _init_and_ba_programs(cuda_device)[which]
    with cache.disable_graphs():
        want = [call(v) for v in (0, 1)]
    c0, r0 = utils.graph_captures, utils.graph_replays
    got0 = call(0)  # a capture (unless an earlier test made it), then a replay
    c1 = utils.graph_captures
    got1 = call(1)  # the same shape: a replay only
    torch.cuda.synchronize()
    assert c1 - c0 <= 1 and graphed.num_entries() >= 1
    assert utils.graph_captures == c1 and utils.graph_replays == r0 + 2
    assert _same_bits(got0, want[0]) and _same_bits(got1, want[1]), which
    assert not _same_bits(want[0], want[1]), which  # the variant is another input


@pytest.mark.parametrize("backend", ["flat", "cg"])
def test_local_ba_backends_graphed_equal_eager_in_a_system(cuda_device, backend, monkeypatch):
    """`track_depth` over 32 frames with the flat or cg local BA, graphed
    and eagerly: trajectories and maps bitwise equal; the graphed run
    captures local BA's graphs of its backend, the windows of the second
    half of the run capture none (the padded plans let successive windows
    share captures), and global BA's captures are not among the entries
    its local BA evicts (each keeps its own)."""
    _, frames = _rgbd_frames(32)
    cfg = SystemConfig(orb=ORBConfig(max_features=1000),
                       local_mapping=LocalMappingConfig(backend=backend))
    graphs = ((schur._local_loop_jit,) if backend == "flat"
              else schur_bucketed.LOCAL_GRAPHS)
    captures_per_call = []
    local_ba = facade.Optimizer.local_bundle_adjustment

    def counted(self, *a, **k):
        c0 = sum(g.captures for g in graphs)
        out = local_ba(self, *a, **k)
        captures_per_call.append(sum(g.captures for g in graphs) - c0)
        return out

    monkeypatch.setattr(facade.Optimizer, "local_bundle_adjustment", counted)
    runs = []
    for eager in (False, True):
        before = [g.num_entries() for g in graphs]
        s = SlamSystem(CAM, cfg, device=cuda_device)
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            tracked = sum(s.track_depth(*f) is not None for f in frames)
        n_ba = s.local_mapper.num_local_ba
        assert tracked == len(frames) and n_ba >= 4
        if not eager:
            assert all(g.num_entries() >= 1 for g in graphs), before
            assert all(g.num_entries() <= g.max_entries for g in graphs)
            assert len(captures_per_call) == n_ba
            assert sum(captures_per_call[n_ba // 2:]) == 0, captures_per_call
        runs.append((s.get_trajectory(), s.store.kf_R.copy(), s.store.kf_t.copy(),
                     s.store.lm_pos.copy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert graphs[0] is not schur._global_loop_jit
    assert not set(map(id, graphs)) & set(map(id, schur_bucketed.GLOBAL_GRAPHS))


def test_monocular_system_graphed_equals_eager(cuda_device):
    """`track_monocular` over 12 frames graphed and eagerly (the initializer
    one graph, drawing outside it): trajectories and maps bitwise equal,
    and the graphed run captured the initializer once."""
    _, frames = _rgbd_frames()
    cfg = SystemConfig(orb=ORBConfig(max_features=1000),
                       tracking=TrackingConfig(min_inliers_local=15))
    runs = []
    for eager in (False, True):
        s = SlamSystem(CAM, cfg, device=cuda_device)
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            tracked = sum(s.track_monocular(img) is not None for img, _ in frames)
        assert tracked >= 8 and s.num_keyframes() >= 2
        runs.append((s.get_trajectory(), s.store.kf_R.copy(), s.store.kf_t.copy(),
                     s.store.lm_pos.copy()))
    assert initializer._initialize_jit.num_entries() >= 1
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def _dist_problem(dev):
    flat, _ = synthetic.make_ba_problem(seed=3, P=24, L=2048, stereo_frac=0.6,
                                        obs_per_landmark=5)
    return schur_bucketed.from_flat(flat, 5, device=dev)


DIST_NAMES = ["dist_lm_loop", "dist_bucketed_step", "dist_flat_step", "dist_start",
              "dist_head", "dist_solve", "dist_tail", "dist_step_head", "dist_step_solve",
              "dist_flat_head", "dist_flat_solve"]


@pytest.mark.parametrize("which", DIST_NAMES)
def test_dist_graphs_replay_eager_bits_and_capture_once(cuda_device, which):
    """Each of distributed BA's graphs (`eval/graph_calls.py`'s inputs, 4
    shards on the card): two calls equal the eager run bit for bit, the
    second a replay only."""
    fn, a, k = graph_calls.dist_calls(_dist_problem(cuda_device), CAM)[which]
    with cache.disable_graphs():
        want = fn(*a, **k)
    got0 = fn(*a, **k)
    c1, r1 = utils.graph_captures, utils.graph_replays
    got1 = fn(*a, **k)
    torch.cuda.synchronize()
    assert utils.graph_captures == c1 and utils.graph_replays == r1 + 1
    assert _same_bits(got0, want) and _same_bits(got1, want), which


@pytest.mark.parametrize("D", [1, 2, 4])
def test_dist_lm_is_one_graph_a_call_and_equals_eager_and_the_segments(cuda_device, D):
    """`distributed_ba_lm` over D shards on one card: the second call
    replays one graph and captures nothing, K2 / K3 launch D x iters / D x
    (iters + 1) times in it, and it equals the eager call and the segment
    driver's replays bit for bit."""
    b, iters = _dist_problem(cuda_device), 5
    mesh = dist_ba.make_mesh(D, cuda_device)
    run = lambda: dist_ba.distributed_ba_lm(b, CAM, mesh, num_iters=iters, robust_delta=2.447)
    first = run()
    assembly.launch_count = assembly.chi2_launch_count = 0
    c0, r0 = utils.graph_captures, utils.graph_replays
    got = run()
    torch.cuda.synchronize()
    assert utils.graph_captures == c0 and utils.graph_replays == r0 + 1
    assert (assembly.launch_count, assembly.chi2_launch_count) == (D * iters, D * (iters + 1))
    with cache.disable_graphs():
        want = run()
    sp = dist_ba.to_shards(dist_ba.partition_bucketed(b, D)[0], mesh)
    whole = dist_ba._lm_loop_jit(sp, cam=CAM, num_iters=iters, robust_delta=2.447, mu0=1e-3)
    seg = dist_ba._lm_segmented(mesh, sp, CAM, iters, 2.447, 1e-3)
    for out in (first, want):
        assert _same_bits((got[0].pose_R, got[0].pose_t, got[0].points, got[1], got[2]),
                          (out[0].pose_R, out[0].pose_t, out[0].points, out[1], out[2]))
    assert _same_bits(tuple(whole), tuple(seg))
    assert float(got[1]) < float(schur_bucketed.chi2_only(b, CAM, b.obs_valid, 2.447))


def test_dist_steps_replay_eager_bits_and_capture_once(cuda_device):
    """`distributed_ba_bucketed` and `distributed_ba` (4 shards, 3 steps):
    a second call replays one graph a step and captures nothing, and equals
    the eager call bit for bit."""
    b = _dist_problem(cuda_device)
    flat = facade.bucketed_to_flat(b)
    mesh = dist_ba.make_mesh(4, cuda_device)
    runs = (lambda: dist_ba.distributed_ba_bucketed(b, CAM, mesh, num_iters=3, mu=1e-3,
                                                    robust_delta=2.447),
            lambda: dist_ba.distributed_ba(flat, CAM, mesh, num_iters=3, mu=1e-3))
    for run in runs:
        run()
        c0, r0 = utils.graph_captures, utils.graph_replays
        got = run()
        torch.cuda.synchronize()
        assert utils.graph_captures == c0 and utils.graph_replays == r0 + 3
        with cache.disable_graphs():
            want = run()
        assert _same_bits((got[0].pose_R, got[0].pose_t, got[0].points, got[1]),
                          (want[0].pose_R, want[0].pose_t, want[0].points, want[1]))


def test_two_gloo_ranks_on_one_card_agree_with_each_other_and_their_eager_rerun(cuda_device):
    """Two `mp_worker` ranks x 2 shards with gloo on one card: equal
    digests, each rank's graphed call equal to its eager rerun, and the
    timed call replays without capturing."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sqrtlm_slam_tpu_torch.parallel.mp_worker", "--coordinator",
         f"localhost:{port}", "--nproc", "2", "--pid", str(pid), "--shards-per-proc", "2",
         "--device", "cuda", "--backend", "gloo", "--poses", "16", "--landmarks", "2048",
         "--obs-per-lm", "4", "--iters", "4"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert len({r["digest"] for r in results}) == 1, results
    for r in results:
        assert r["eager_bitwise_equal"] and r["graph_captures"] == 0, r
        assert r["first_call_captures"] > 0 and r["graph_replays"] > 0, r
        assert 0 < r["cuda_launches"] < r["eager_cuda_launches"], r
