"""The asynchronous mapping worker and pipelined tracking of the port.

Gates of the JAX package's own tests on the port: tests/test_robustness.py's
async run (>= 8 of 10 frames tracked, >= 2 keyframes, ATE < 0.15 m, the
worker joined after `shutdown`) and tests/test_e2e_synthetic.py's pipelined
run (every frame tracked, ATE < 0.1 m, `flush` idempotent), cut to 12
frames here; the 25-frame pipelined run beside the JAX package's is `slow`.
The port departs from the JAX worker on two points: an exception on the
worker is raised in the tracking thread at the next call, where the JAX
worker would stop and leave `flush` waiting; and a keyframe is queued
only when its frame is done, so the frame's trajectory entry never races
the worker's local BA for the lock (the JAX worker may take the keyframe
first, and the entry then follows its optimized pose).
"""

import sys
import time

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.pipeline import tracking
from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig, TrackState


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """2 CPU threads, as the port's other test modules run (restored after
    the module): at the machine's default every run here spun its OpenMP
    threads against the tracking and mapping threads and the other test
    processes, ~5x the time."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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


def _async_run(tracker_first: bool):
    """An async run flushed after every frame. `tracker_first`: the worker
    takes a keyframe off its queue only once the frame that made it has
    recorded its trajectory entry, as when the tracking thread wins the
    lock."""
    world = SyntheticWorld(seed=2, n_points=1000)
    s = SlamSystem(DEFAULT_CAM, SystemConfig(orb=ORBConfig(max_features=600),
                                             async_mapping=True), device="cpu")
    if tracker_first:
        q, get = s._kf_queue, s._kf_queue.get

        def get_after_the_entry():
            kf = get()
            t_end = time.monotonic() + 30
            while (kf is not None and not (s.tracker.trajectory
                                           and s.tracker.trajectory[-1][1] >= kf)
                   and time.monotonic() < t_end):
                time.sleep(1e-3)
            return kf
        q.get = get_after_the_entry  # from the second keyframe (the worker waits in get)
    for T in forward_trajectory(13, step=0.35):  # local BA from frame 11
        s.track_depth(*world.render(T, DEFAULT_CAM))
        s.flush()
    s.shutdown()
    return s


def test_a_keyframe_is_queued_after_its_frame_is_recorded():
    """The same bits whether or not the worker is held back until the
    frame that made a keyframe has recorded its trajectory entry: it cannot
    reach that keyframe (nor move its pose by local BA) before then."""
    free, held = _async_run(False), _async_run(True)
    assert free.local_mapper.num_local_ba >= 1
    assert np.array_equal(free.get_trajectory(), held.get_trajectory())
    assert np.array_equal(free.store.kf_R, held.store.kf_R)


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


class _StepReads:
    """Counts, while installed, the tracker's step dispatches, the reads
    made inside a dispatch (`tracking.to_host`) and the waits that consume
    a step (`tracking.wait_host`)."""

    def __init__(self, mp: pytest.MonkeyPatch):
        self.calls = {"dispatch": 0, "reads_in_dispatch": 0, "consume_waits": 0}
        inside = [False]
        to_host, wait_host = tracking.to_host, tracking.wait_host
        dispatch = tracking.Tracker._dispatch_step
        calls = self.calls

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

        mp.setattr(tracking, "to_host", counting_to_host)
        mp.setattr(tracking, "wait_host", counting_wait_host)
        mp.setattr(tracking.Tracker, "_dispatch_step", marked_dispatch)


@pytest.fixture(scope="module")
def pipelined_run():
    """12 pipelined frames, their step reads counted (`_StepReads`)."""
    world = SyntheticWorld(seed=3, n_points=900)
    poses = forward_trajectory(12, step=0.4)
    s = SlamSystem(DEFAULT_CAM, _pipelined_cfg(True), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        reads = _StepReads(mp)
        results = [s.track_depth(*world.render(T, DEFAULT_CAM)) for T in poses]
        deferred = len(s.tracker.trajectory)
        s.get_trajectory()  # consumes the deferred frame's step
    return s, poses, results, deferred, reads.calls


def test_pipelined_tracks_accurately(pipelined_run):
    s, poses, results, deferred, _ = pipelined_run
    assert all(r is not None for r in results)
    est = s.get_trajectory()  # finalizes the deferred frame
    assert deferred == len(poses) - 1 and est.shape[0] == len(poses)
    np.testing.assert_array_equal(s.trajectory_frame_ids(), np.arange(len(poses)))
    rmse, _ = ate_rmse(est, _gt(poses))
    assert rmse < 0.1, f"pipelined ATE {rmse}"
    assert s.state == TrackState.OK and s.num_keyframes() >= 2


def test_pipelined_dispatch_reads_nothing_and_sync_reads_stage_a(pipelined_run, monkeypatch):
    """Dispatching a step reads nothing back in pipelined mode (stage A at
    both radii, the retry decided on the device): counted over the shared
    pipelined run; sync mode reads stage A's inlier count once a step (5
    frames of the same world and poses). Consuming a step is one read in
    both."""
    _, poses, _, _, calls = pipelined_run
    assert calls["dispatch"] == len(poses) - 1 == calls["consume_waits"]
    assert calls["reads_in_dispatch"] == 0, calls
    world = SyntheticWorld(seed=3, n_points=900)
    poses = forward_trajectory(5, step=0.4)
    calls = _StepReads(monkeypatch).calls
    s = SlamSystem(DEFAULT_CAM, _pipelined_cfg(False), device="cpu")
    assert all(s.track_depth(*world.render(T, DEFAULT_CAM)) is not None for T in poses)
    s.get_trajectory()
    assert calls["dispatch"] == len(poses) - 1 == calls["consume_waits"]
    assert calls["reads_in_dispatch"] == calls["dispatch"], calls


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
