"""The loop correction at KITTI 00's scale on the card: `chip_smoke.py`
phase 22 (`kitti00_scale_phase`) alone. `benchmarks/bench_scale.py`'s flow
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
