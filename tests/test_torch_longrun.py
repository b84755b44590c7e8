"""`eval/longrun.py`'s `run_long` in both packages on the CPU.

Tier 1: one short, loop-free stretch of the ring (12 frames, radius 12 m,
0.09 revolutions, 2,500 points, 600 features; ~25 s a package on 2 CPU
threads) through the JAX package's `run_long` and the port's, each once (a
module fixture), then four checks:
the summary keys are equal but for the port's `device`; the tracked count
is equal; the keyframes created are within 1 (ORB descriptors differ from
the JAX package's on ~20 % of keypoints by < 1 bit on average, which can
move one keyframe decision); both ATEs are below 0.1 m and within 0.02 m of
each other.

`slow`: both packages over a 160-frame ring of radius 12 m and 1.3
revolutions, which closes a loop in both on the CPU: the loops closed are
equal and the ATEs within 0.05 m of each other, both below 0.3 m (the
smoke's gate on its ring, chip_smoke.py phase 9).
"""

import pytest
import torch

from sqrtlm_slam_tpu.eval import longrun as j_longrun
from sqrtlm_slam_tpu_torch.eval import longrun

SHORT = dict(n_frames=12, radius=12.0, revolutions=0.09, n_points=2500, max_features=600,
             progress_every=0)
KF_TOL = 1
ATE_MAX_M, ATE_TOL_M = 0.1, 0.02


def _quiet(*_):
    pass


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port's runs on 2 CPU threads (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def short_runs():
    j_out, _ = j_longrun.run_long(**SHORT, log=_quiet)
    out, _ = longrun.run_long(**SHORT, device="cpu", log=_quiet)
    return j_out, out


def test_summary_keys_match(short_runs):
    j_out, out = short_runs
    assert set(out) - {"device"} == set(j_out)
    assert out["device"] == "cpu" and out["frames"] == j_out["frames"] == SHORT["n_frames"]


def test_tracked_frames_match(short_runs):
    j_out, out = short_runs
    assert out["tracked"] == j_out["tracked"], (out, j_out)


def test_keyframes_created_within_one(short_runs):
    j_out, out = short_runs
    assert abs(out["keyframes_created"] - j_out["keyframes_created"]) <= KF_TOL, (out, j_out)
    assert out["loops_closed"] == j_out["loops_closed"] == 0


def test_ate_matches(short_runs):
    j_out, out = short_runs
    assert out["ate_rmse_m"] < ATE_MAX_M and j_out["ate_rmse_m"] < ATE_MAX_M, (out, j_out)
    assert abs(out["ate_rmse_m"] - j_out["ate_rmse_m"]) <= ATE_TOL_M, (out, j_out)


LOOP = dict(n_frames=160, radius=12.0, revolutions=1.3, n_points=2500, max_features=600,
            progress_every=0)
LOOP_ATE_MAX_M, LOOP_ATE_TOL_M = 0.3, 0.05


@pytest.mark.slow
def test_ring_with_a_loop_matches_the_jax_package():
    """160 frames over 1.3 revolutions of the 12 m ring: both packages close
    one loop (the JAX package's ATE 0.080 m, the port's 0.085; ~3 and ~6 min
    on 2 CPU threads)."""
    j_out, _ = j_longrun.run_long(**LOOP, log=_quiet)
    out, _ = longrun.run_long(**LOOP, device="cpu", log=_quiet)
    assert j_out["loops_closed"] >= 1, j_out
    assert out["loops_closed"] == j_out["loops_closed"], (out, j_out)
    assert out["ate_rmse_m"] < LOOP_ATE_MAX_M and j_out["ate_rmse_m"] < LOOP_ATE_MAX_M
    assert abs(out["ate_rmse_m"] - j_out["ate_rmse_m"]) <= LOOP_ATE_TOL_M, (out, j_out)
