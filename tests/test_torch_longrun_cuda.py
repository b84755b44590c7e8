"""`eval/longrun.py`'s `run_long` on the card, twice in one process over
shorter rings of radius 12 m (2,500 points, 600 features; the default
configuration of `run_long` otherwise) that close a loop each: 160 frames
over 1.3 revolutions, then 280 over 2.3 (its loop near frame 125, on a
map of another size). A larger ring at `run_long`'s defaults drifts too
far for a second loop to pass the loop closer's drift gate (chip_smoke.py
phase 19), and on one small ring the first loop connects the whole map.
After the first loop no graphed function captures inputs of a shape it
had not captured before, except the per-loop programs (`max_entries=1`:
the essential graph's step, global BA's three graphs) inside a loop's
correction; and the device memory reserved after `empty_cache` at the
second loop is within `MEMORY_MARGIN_MB` of the first loop's. `chip_smoke.py` phase 19 runs the
same checks at `run_long`'s defaults.

Marked `cuda`: each test skips where no CUDA device exists. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_longrun_cuda.py -m cuda -q
"""

import pytest
import torch

from sqrtlm_slam_tpu_torch.eval import longrun
from sqrtlm_slam_tpu_torch.loop import closing
from sqrtlm_slam_tpu_torch.utils import cache

pytestmark = pytest.mark.cuda

RINGS = (dict(n_frames=160, radius=12.0, revolutions=1.3, n_points=2500, max_features=600,
              progress_every=0),
         dict(n_frames=280, radius=12.0, revolutions=2.3, n_points=2500, max_features=600,
              progress_every=0))
# A loop's programs are recaptured at the map's new size (~60 and ~80
# keyframes here); a global BA capture at the ring's size keeps ~150 MB
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5).
MEMORY_MARGIN_MB = 256.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_ring_with_two_loops_holds_its_captures_and_memory(cuda_device, monkeypatch):
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
    for ring in RINGS:
        out, s = longrun.run_long(**ring, device=cuda_device, log=lambda *_: None)
        assert out["tracked"] == ring["n_frames"] and out["loops_closed"] >= 1, out
    assert loops[0] >= 2, loops
    per_loop = {n for n, g in cache.graphed_functions().items() if g.max_entries == 1}
    before = {(n, shapes) for i, n, shapes, _ in events if i == 0}
    new_shapes = [(i, n) for i, n, shapes, in_corr in events
                  if i >= 1 and (n, shapes) not in before
                  and any(m == n for m, _ in before) and not (n in per_loop and in_corr)]
    assert not new_shapes, new_shapes
    assert memory_mb[1] <= memory_mb[0] + MEMORY_MARGIN_MB, memory_mb
