"""The LiDAR soak on the card at full depth: `chip_smoke.py` phase 21
(`lidar_soak_phase`) alone over `kitti_synth`'s 1,000 scans (written first,
scans only, under build/chip_smoke_lidar): `run_kitti --mode lidar` over
every scan, the pose-graph backends over its 1,000-pose chain (graphed,
replayed and eager bitwise equal; on the JAX package's own chain within
`lidar_soak.BACKEND_TOL_M` of its result), mapping over the first lap and
localization over every scan against its map, each held against the JAX
package's CPU record (`eval/lidar_soak.py`'s JAX_RECORD) by
`lidar_soak.gates`; no capture after scan 100 but at a new `pad_cloud`
bucket; memory_reserved as held at the end within 256 MB of its reading at
scan 100; none of K1-K3 launched.

Marked `cuda`: the test skips where no CUDA device exists. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lidar_soak_cuda.py -m cuda -q
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
        pytest.skip("needs a CUDA device: the phase runs the port's graphs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.CARD = chip_smoke.card_line()
    return chip_smoke


def test_lidar_soak_at_full_depth(smoke):
    launches = smoke.lidar_soak_phase()  # raises on any failed gate
    assert launches == {"hamming": 0, "ba_assembly": 0, "ba_chi2": 0}
