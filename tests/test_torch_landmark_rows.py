"""Reclaiming dead landmark rows (`mapstore.compact_landmarks`, called by
`SlamSystem._reclaim_landmarks`).

The store allocates landmark rows append-only; the long run of
`eval/longrun.py` at its defaults runs out of its 400,000 rows near frame
850, and the port then compacts the live rows in order. Held here on the
CPU: compaction keeps every live row's fields under the renumbering and
blanks the rest; it fires only below two keyframes' worth of rows; and a
run of the ring that compacts before every frame (sync and pipelined
tracking, and asynchronous mapping with its worker and the loop closer's
GBA thread, flushed after every frame in both runs so that the worker's
timing is the same) gives the same bits as one that never does:
trajectory, keyframe poses, the live landmarks' fields in id order, and
the landmarks created.
"""

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu_torch.eval import synthetic
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.loop import LoopClosingConfig
from sqrtlm_slam_tpu_torch.mapstore import MapStore, compact_landmarks
from sqrtlm_slam_tpu_torch.pipeline import system as system_mod
from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig

N_FRAMES = 8
LM_FIELDS = [f for f in vars(MapStore(max_keyframes=1, max_landmarks=1, feats_per_kf=1))
             if f.startswith("lm_")]
_PLAIN = {}  # mode -> the run that never compacts (the last test mutates "sync")
MODES = ["sync", "pipelined", "async"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The ring runs on 2 CPU threads (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ring_run(monkeypatch, mode: str, compact_every_frame: bool):
    """The ring of eval/longrun.py at a small size through `track_depth`
    (its configuration: dense ORB grid, min_inliers_local 20, loop
    detection on), in `mode` (one of MODES)."""
    if compact_every_frame:  # more keyframes' worth kept free than the store holds
        monkeypatch.setattr(system_mod, "RECLAIM_KEYFRAMES", 10**9)
    cam = synthetic.DEFAULT_CAM
    world = synthetic.ring_world(seed=7, n_points=2500, radius=12.0, band=6.0)
    cfg = SystemConfig(orb=ORBConfig(max_features=600, per_cell=6, cell_size=16),
                       tracking=TrackingConfig(min_inliers_local=20,
                                               pipelined=mode == "pipelined"),
                       loop_detection=True, async_mapping=mode == "async",
                       max_keyframes=64, max_landmarks=20000)
    s = SlamSystem(cam, cfg, device="cpu", loop_cfg=LoopClosingConfig())
    for T in synthetic.ring_trajectory(N_FRAMES, radius=12.0, frac=0.064):
        s.track_depth(*world.render(T, cam))
        if mode == "async":
            s.flush()
    s.shutdown()
    monkeypatch.undo()
    return s


def _plain(mode: str):
    if mode not in _PLAIN:
        _PLAIN[mode] = _ring_run(pytest.MonkeyPatch(), mode, compact_every_frame=False)
    return _PLAIN[mode]


def _state(s):
    st = s.store
    live = np.flatnonzero(st.lm_valid[:st.num_lm])
    return ([s.get_trajectory(), st.kf_R[:st.num_kf], st.kf_t[:st.num_kf],
             st.kf_obs_lm[:st.num_kf] >= 0]
            + [getattr(st, f)[live] for f in LM_FIELDS])


@pytest.mark.parametrize("mode", MODES)
def test_compacting_every_frame_gives_the_same_bits(monkeypatch, mode):
    plain = _plain(mode)
    compacted = _ring_run(monkeypatch, mode, compact_every_frame=True)
    assert compacted.landmarks_reclaimed > 0
    assert (compacted.store.num_lm + compacted.landmarks_reclaimed == plain.store.num_lm)
    for a, b in zip(_state(plain), _state(compacted)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8) if a.dtype != bool else a,
                              b.view(np.uint8) if b.dtype != bool else b)


def test_compaction_keeps_live_rows_in_order():
    src = _plain("sync").store
    store = MapStore(max_keyframes=src.max_keyframes, max_landmarks=src.max_landmarks,
                     feats_per_kf=src.feats_per_kf, num_words=src.num_words)
    for name, value in vars(src).items():
        if isinstance(value, np.ndarray):
            getattr(store, name)[...] = value
    store.num_kf, store.num_lm, store.version = src.num_kf, src.num_lm, src.version
    L = src.num_lm
    dead = np.flatnonzero(~src.lm_valid[:L])
    assert len(dead) > 0  # culling and fusion left dead rows
    held = dead[:1]
    remap = compact_landmarks(store, hold=[held])
    live = np.flatnonzero(src.lm_valid[:L])
    kept = np.union1d(live, held)
    assert store.num_lm == len(kept) and np.array_equal(remap[kept], np.arange(len(kept)))
    assert (remap[np.setdiff1d(np.arange(L), kept)] == -1).all()
    blank = MapStore(max_keyframes=1, max_landmarks=1, feats_per_kf=1)
    for f in LM_FIELDS:
        a, b = getattr(store, f), getattr(src, f)
        assert np.array_equal(a[:len(kept)], b[kept]), f
        assert (a[len(kept):L] == getattr(blank, f)[0]).all(), f
    obs = src.kf_obs_lm[:src.num_kf]
    want = np.where(obs >= 0, remap[np.maximum(obs, 0)], -1)
    assert np.array_equal(store.kf_obs_lm[:src.num_kf], want)
    assert store.version == src.version + 1


def test_reclaim_fires_below_two_keyframes_of_rows():
    s = _plain("sync")  # the last test: it shrinks the store's capacity
    store = s.store
    n = store.num_lm
    store.max_landmarks = n + 2 * store.feats_per_kf  # room for two keyframes: kept
    s._reclaim_landmarks()
    assert store.num_lm == n and s.landmarks_reclaimed == 0
    store.max_landmarks -= 1
    n_valid = int(store.lm_valid[:n].sum())
    s._reclaim_landmarks()  # live rows and those the tracker holds stay
    assert n_valid <= store.num_lm < n and int(store.lm_valid[:store.num_lm].sum()) == n_valid
    assert s.landmarks_reclaimed == n - store.num_lm
