"""The captured CUDA graphs of the port (`utils.cache`) on the card: every
graphed function replays its eager run bit for bit, outputs survive later
replays, replays count the kernels they launch, a capture that fails
raises, and two threads capture and replay at once.

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
from sqrtlm_slam_tpu_torch.eval import planeworld, synthetic
from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.lidar import features as lidar_features
from sqrtlm_slam_tpu_torch.lidar import odometry
from sqrtlm_slam_tpu_torch.ops import hamming
from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed
from sqrtlm_slam_tpu_torch.pipeline import frame as frame_mod
from sqrtlm_slam_tpu_torch.pipeline import local_mapping, tracking
from sqrtlm_slam_tpu_torch.pipeline.local_mapping import LocalMappingConfig
from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
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


def _scan():
    world = planeworld.street_circuit_world(seed=0, A=12.0, B=8.0, half_width=4.0, texel=0.05,
                                            panel_spacing=6.0)
    poses, _ = planeworld.circuit_trajectory(4, A=12.0, B=8.0, corner_r=3.0, step=0.5)
    raw = world.lidar_scan(poses[3], planeworld.T_CAM_VELO, n_rings=32, n_azimuth=720,
                           noise_seed=3)
    pts, _ = planeworld.center_scan_on_columns(raw, planeworld.T_CAM_VELO, 0.5)
    return pts


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
    ]


NAMES = ["build_frame_rgbd", "build_frame_mono", "build_frame_fusion", "build_frame_stereo",
         "extract_features", "stage_a", "stages_bc", "stages_bc_fused", "local_ba"]


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

