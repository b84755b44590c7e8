"""The loop correction at KITTI 00's scale on the card: `chip_smoke.py`
phase 22 (`kitti00_scale_phase`) alone, phase 23 (`kitti00_dist_phase`:
distributed BA at 4, 2 and 1 shards and the flat engine's global BA on
phase 22's store after the essential graph, `scale_kitti00.dist_gates`)
alone, and a superseded GBA that gives its memory back with the garbage
collector off. `benchmarks/bench_scale.py`'s flow
at 1,400 keyframes x 280,000 landmarks (`eval/scale_kitti00.py`'s FLOW):
the essential graph and global BA each graphed, replayed and eager,
bitwise equal; a GBA superseded after its first chunk returns False,
leaves the store as it was and gives its memory back; the ATE after each
stage and chi2 after GBA held against the JAX package's CPU record
(`eval/scale_kitti00_jax.json`) by `scale_kitti00.gates`; K2 and K3
launched.

Marked `cuda`: the test skips where no CUDA device exists. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scale_cuda.py -m cuda -q
"""

import copy
import gc
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase runs the port's graphs and kernels on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.CARD = chip_smoke.card_line()
    return chip_smoke


def test_kitti00_loop_correction(smoke):
    from sqrtlm_slam_tpu_torch.ops import build

    build.load_all(("hamming", "ba_assembly"))
    launches = smoke.kitti00_scale_phase()  # raises on any failed gate
    assert launches["ba_assembly"] > 0 and launches["ba_chi2"] > 0
    assert launches["hamming"] == 0


def test_kitti00_distributed_ba(smoke):
    from sqrtlm_slam_tpu_torch.ops import build

    build.load_all(("hamming", "ba_assembly"))
    launches = smoke.kitti00_dist_phase()  # raises on any failed gate
    assert launches["ba_assembly"] > 0 and launches["ba_chi2"] > 0
    assert launches["hamming"] == 0


def test_superseded_gba_gives_its_memory_back_without_a_collection(smoke):
    """A GBA of the flow's store superseded after its first chunk, with the
    garbage collector off from before the reading to after it: the memory
    kept (`memory_reserved` after `empty_cache`) is back within
    KITTI00_SUPERSEDED_MARGIN_MB. A full GBA on a copy first captures the
    graphs, so that the superseded one replays them. (A reference cycle in
    the graph cache's output unflattening held a replay's outputs until a
    collection.)"""
    from sqrtlm_slam_tpu_torch.eval import scale_kitti00
    from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig
    from sqrtlm_slam_tpu_torch.ops import build

    build.load_all(("ba_assembly",))
    flow = scale_kitti00.FLOW
    store, _, _ = smoke.kitti00_scale_store()
    cfg = LoopClosingConfig(edge_cap=flow["edge_cap"], gba_iters=flow["gba_iters"], gba_chunk=5)
    assert LoopCloser(copy.deepcopy(store), DEFAULT_CAM, cfg=cfg).run_global_ba()
    lc = LoopCloser(store, DEFAULT_CAM, cfg=cfg)

    def supersede():
        lc.gba_generation += 1
        lc._gba_tick = lambda: None

    lc._gba_tick = supersede
    gc.collect()
    gc.disable()
    try:
        before = smoke.kept_bytes()
        assert lc.run_global_ba() is False and lc.num_gba_aborted == 1
        after = smoke.kept_bytes()
    finally:
        gc.enable()
    assert abs(after - before) <= smoke.KITTI00_SUPERSEDED_MARGIN_MB * 2**20, (before, after)
