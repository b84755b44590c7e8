"""The asynchronous mapping worker and pipelined tracking of the port.

Gates of the JAX package's own tests on the port: tests/test_robustness.py's
async run (>= 8 of 10 frames tracked, >= 2 keyframes, ATE < 0.15 m, the
worker joined after `shutdown`) and tests/test_e2e_synthetic.py's pipelined
run (every frame tracked, ATE < 0.1 m, `flush` idempotent), cut to 12
frames here; the 25-frame pipelined run beside the JAX package's is `slow`.
The port departs from the JAX worker on one point: an exception on the
worker is raised in the tracking thread at the next call, where the JAX
worker would stop and leave `flush` waiting.
"""

import sys

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.pipeline import tracking
from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig, TrackState


def _gt(poses) -> np.ndarray:
    out = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = T.R, T.t
        out.append(np.linalg.inv(M))
    return np.stack(out)


def _pipelined_cfg(pipelined: bool) -> SystemConfig:
    return SystemConfig(
        orb=ORBConfig(max_features=600),
        tracking=TrackingConfig(init_min_depth_kp=80, local_map_capacity=1024,
                                pipelined=pipelined),
        max_keyframes=64, max_landmarks=8000)


def test_async_mapping_tracks_drains_and_joins():
    """tests/test_robustness.py's async run, under a short thread switch
    interval: every queued keyframe is mapped exactly once, in order."""
    world = SyntheticWorld(seed=2, n_points=1000)
    poses = forward_trajectory(10, step=0.35)
    s = SlamSystem(DEFAULT_CAM, SystemConfig(orb=ORBConfig(max_features=600),
                                             async_mapping=True), device="cpu")
    assert s.tracker.map_lock is s.map_lock and s._worker.is_alive()
    mapped = []
    process = s.local_mapper.process_keyframe

    def counted(kf):
        mapped.append(kf)
        return process(kf)
    s.local_mapper.process_keyframe = counted
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ok = sum(s.track_depth(*world.render(T, DEFAULT_CAM)) is not None for T in poses)
        s.flush()
    finally:
        sys.setswitchinterval(interval)
    assert ok >= 8
    assert s.num_keyframes() >= 2
    assert mapped == list(range(s.store.num_kf))
    est = s.get_trajectory()
    ids = s.trajectory_frame_ids()
    rmse, _ = ate_rmse(est, _gt([poses[i] for i in ids]))
    assert rmse < 0.15, rmse
    s.shutdown()
    s._worker.join(timeout=10)
    assert s._shutdown and not s._worker.is_alive()
    s.shutdown()  # idempotent
    with pytest.raises(RuntimeError, match="shut down"):
        s.track_depth(*world.render(poses[0], DEFAULT_CAM))


def test_a_failing_worker_raises_in_the_tracking_thread():
    world = SyntheticWorld(seed=2, n_points=1000)
    poses = forward_trajectory(2, step=0.35)
    s = SlamSystem(DEFAULT_CAM, SystemConfig(orb=ORBConfig(max_features=600),
                                             async_mapping=True), device="cpu")

    def boom(kf):
        raise ValueError(f"mapping keyframe {kf} failed")
    s.local_mapper.process_keyframe = boom
    assert s.track_depth(*world.render(poses[0], DEFAULT_CAM)) is not None  # queues KF 0
    s._kf_queue.join()  # the worker has failed on it
    with pytest.raises(RuntimeError, match="mapping worker failed") as e:
        s.track_depth(*world.render(poses[1], DEFAULT_CAM))
    assert isinstance(e.value.__cause__, ValueError)
    with pytest.raises(RuntimeError):
        s.flush()
    with pytest.raises(RuntimeError):
        s.shutdown()
    s._worker.join(timeout=10)
    assert not s._worker.is_alive()


@pytest.fixture(scope="module")
def pipelined_run():
    world = SyntheticWorld(seed=3, n_points=900)
    poses = forward_trajectory(12, step=0.4)
    s = SlamSystem(DEFAULT_CAM, _pipelined_cfg(True), device="cpu")
    results = [s.track_depth(*world.render(T, DEFAULT_CAM)) for T in poses]
    deferred = len(s.tracker.trajectory)
    return s, poses, results, deferred


def test_pipelined_tracks_accurately(pipelined_run):
    s, poses, results, deferred = pipelined_run
    assert all(r is not None for r in results)
    est = s.get_trajectory()  # finalizes the deferred frame
    assert deferred == len(poses) - 1 and est.shape[0] == len(poses)
    np.testing.assert_array_equal(s.trajectory_frame_ids(), np.arange(len(poses)))
    rmse, _ = ate_rmse(est, _gt(poses))
    assert rmse < 0.1, f"pipelined ATE {rmse}"
    assert s.state == TrackState.OK and s.num_keyframes() >= 2


def test_pipelined_dispatch_reads_nothing_and_sync_reads_stage_a(monkeypatch):
    """Dispatching a step reads nothing back in pipelined mode (stage A at
    both radii, the retry decided on the device); sync mode reads stage A's
    inlier count once a step. Consuming a step is one read in both."""
    world = SyntheticWorld(seed=3, n_points=900)
    poses = forward_trajectory(5, step=0.4)
    calls = {"dispatch": 0, "reads_in_dispatch": 0, "consume_waits": 0}
    inside = [False]
    to_host, wait_host = tracking.to_host, tracking.wait_host
    dispatch = tracking.Tracker._dispatch_step

    def counting_to_host(*xs):
        calls["reads_in_dispatch"] += inside[0]
        return to_host(*xs)

    def counting_wait_host(copy):
        calls["consume_waits"] += 1
        return wait_host(copy)

    def marked_dispatch(self, frame):
        calls["dispatch"] += 1
        inside[0] = True
        try:
            return dispatch(self, frame)
        finally:
            inside[0] = False

    monkeypatch.setattr(tracking, "to_host", counting_to_host)
    monkeypatch.setattr(tracking, "wait_host", counting_wait_host)
    monkeypatch.setattr(tracking.Tracker, "_dispatch_step", marked_dispatch)
    for pipelined in (True, False):
        calls.update(dispatch=0, reads_in_dispatch=0, consume_waits=0)
        s = SlamSystem(DEFAULT_CAM, _pipelined_cfg(pipelined), device="cpu")
        assert all(s.track_depth(*world.render(T, DEFAULT_CAM)) is not None for T in poses)
        s.get_trajectory()
        assert calls["dispatch"] == len(poses) - 1 == calls["consume_waits"]
        assert calls["reads_in_dispatch"] == (0 if pipelined else calls["dispatch"]), calls


def test_tracker_flush_is_idempotent(pipelined_run):
    s = pipelined_run[0]
    s.tracker.flush()
    n = len(s.tracker.trajectory)
    s.tracker.flush()
    s.tracker.flush()
    assert len(s.tracker.trajectory) == n and s.tracker._pending is None
    res = s.get_slam_result()
    assert res["trajectory"].shape[0] == n


@pytest.mark.slow
def test_pipelined_25_frames_beside_the_jax_package():
    """tests/test_e2e_synthetic.py's full pipelined run in both packages:
    every frame tracked and ATE < 0.1 m in each; keyframe counts within 2
    (the one-frame keyframe latency moves the set)."""
    from sqrtlm_slam_tpu.eval import synthetic as j_synthetic
    from sqrtlm_slam_tpu.frontend import orb as j_orb
    from sqrtlm_slam_tpu.pipeline import SlamSystem as JSlam
    from sqrtlm_slam_tpu.pipeline import SystemConfig as JCfg
    from sqrtlm_slam_tpu.pipeline import TrackingConfig as JTrk
    from sqrtlm_slam_tpu_torch import convert

    j_cfg = JCfg(orb=j_orb.ORBConfig(max_features=600),
                 tracking=JTrk(init_min_depth_kp=80, local_map_capacity=1024, pipelined=True),
                 max_keyframes=64, max_landmarks=8000)
    world = j_synthetic.SyntheticWorld(seed=3, n_points=900)
    poses = j_synthetic.forward_trajectory(25, step=0.4)
    frames = [tuple(np.array(a) for a in world.render(T, j_synthetic.DEFAULT_CAM))
              for T in poses]
    js = JSlam(j_synthetic.DEFAULT_CAM, j_cfg)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ts = SlamSystem(DEFAULT_CAM, convert.system_config(j_cfg), device="cpu")
        assert ts.tracker.cfg.pipelined
        ok_t = sum(ts.track_depth(img, d) is not None for img, d in frames)
    finally:
        torch.set_num_threads(prev)
    ok_j = sum(js.track_depth(img, d) is not None for img, d in frames)
    gt = _gt(poses)
    assert ok_t == ok_j == len(poses)
    for s in (ts, js):
        est = s.get_trajectory()
        assert est.shape[0] == len(poses)
        assert ate_rmse(est, gt)[0] < 0.1
    assert abs(ts.num_keyframes() - js.num_keyframes()) <= 2
