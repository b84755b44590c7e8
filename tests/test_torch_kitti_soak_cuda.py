"""The fusion soak on the card, cut to the frames through its first loop:
`run_kitti --mode fusion --loop` at the runner's defaults over the first
`FRAMES` frames of the `kitti_synth` sequence (1226x370, 64 x 1800-ray
scans centred on the range image's columns), which the first revisit of
the street circuit closes a loop in (`chip_smoke.py` phase 20 runs the
same depth with the outcome gates against the JAX package's record).
After the first loop no graphed function captures inputs of a shape it
had not captured before, except the per-loop programs (`max_entries=1`:
the essential graph's step, global BA's three graphs) inside a loop's
correction; the device memory reserved after `empty_cache` at the end is
within `MEMORY_MARGIN_MB` of its reading after the first loop; K1, K2 and
K3 launch.

Marked `cuda`: the test skips where no CUDA device exists. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kitti_soak_cuda.py -m cuda -q
"""

import os

import pytest
import torch

from sqrtlm_slam_tpu_torch import run_kitti
from sqrtlm_slam_tpu_torch.eval import kitti_synth
from sqrtlm_slam_tpu_torch.loop import closing
from sqrtlm_slam_tpu_torch.ops import hamming
from sqrtlm_slam_tpu_torch.optim import assembly
from sqrtlm_slam_tpu_torch.utils import cache

pytestmark = pytest.mark.cuda

FRAMES = 600  # the first loop of the second lap (frame 593 on the card) and its GBA
MEMORY_MARGIN_MB = 512.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_fusion_soak_through_its_first_loop(cuda_device, tmp_path, monkeypatch):
    root = str(tmp_path / "kitti")
    kitti_synth.generate(root, n_frames=FRAMES, workers=min(8, os.cpu_count() or 1),
                         centred=True, log=lambda *a: None)
    events = []  # (loops closed, graphed function, its inputs' shapes, inside a correction)
    loops, memory_mb = [0], []
    inside = [False]
    names = {}
    capture = cache.Graphed._capture

    def recording_capture(self, key, *a, **k):
        if not names:
            names.update({id(g): n for n, g in cache.graphed_functions().items()})
        # key = (statics, argument nesting, shapes / strides / dtypes, TF32)
        events.append((loops[0], names.get(id(self), self.__name__), key[1:3], inside[0]))
        return capture(self, key, *a, **k)

    correct = closing.LoopCloser.correct_loop

    def recording_correct(self, *a, **k):
        inside[0] = True
        try:
            ok = correct(self, *a, **k)
        finally:
            inside[0] = False
        if ok:
            loops[0] += 1
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            memory_mb.append(torch.cuda.memory_reserved(cuda_device) / 2**20)
        return ok

    monkeypatch.setattr(cache.Graphed, "_capture", recording_capture)
    monkeypatch.setattr(closing.LoopCloser, "correct_loop", recording_correct)
    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    res = run_kitti.main(["--root", root, "--seq", "00", "--mode", "fusion", "--loop",
                          "--frames", str(FRAMES), "--out", str(tmp_path / "traj.txt")])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    end_mb = torch.cuda.memory_reserved(cuda_device) / 2**20

    assert res["tracked"] >= 0.9 * FRAMES and res["loops_closed"] >= 1, res
    assert hamming.launch_count > 0 and assembly.launch_count > 0
    assert assembly.chi2_launch_count > 0  # the loop's global BA
    per_loop = {n for n, g in cache.graphed_functions().items() if g.max_entries == 1}
    before = {(n, key) for n_loops, n, key, _ in events if n_loops == 0}
    late = [(n_loops, n) for n_loops, n, key, in_corr in events
            if n_loops >= 1 and (n, key) not in before
            and any(m == n for m, _ in before) and not (n in per_loop and in_corr)]
    assert not late, late
    assert end_mb <= memory_mb[0] + MEMORY_MARGIN_MB, (memory_mb, end_mb)
