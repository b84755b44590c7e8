"""The port's sqrt-Schur tail (`optim/schur_bucketed.py::_pieces_tail`)
against the JAX package's `_pieces_tail` (float32, CPU) on the same
reductions, made with the JAX package's own generators from a seed: at
bench.py's structure (96 poses, 8,192 landmarks, 5 slots) and on
`eval/scale.py::make_scale_store` at a cut of KITTI 00's flow (48
keyframes, 9,600 landmarks, 5 observations in 7 slots).

The JAX package scatters V into a one-hot (P, L, 6, 3) Y and forms Y Y^T;
the port sums each landmark's slot pairs by camera pair in float64 and
rounds once (`_yyt`), and rhs_corr's slots by camera. Tolerance: S_half
and rhs_corr within 5e-6 of each output's largest entry (measured, mu 1e-3
and 1e-1: S_half 1.2e-6 and 2.3e-7 at bench.py's structure, 2.4e-7 and
1.2e-7 on the cut; rhs_corr at most 1.6e-7), Minv within 5e-5 of its
largest entry (the same closed form, which XLA fuses otherwise: measured
1.1e-5 at mu 1e-3, where the damped Hll of a few landmarks is near
singular; S_half's largest error follows from it). U and bl pass through:
bitwise. Two calls give the same bits, and no tensor of the port's tail
has both a pose and a landmark axis.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sqrtlm_slam_tpu.eval import scale as j_scale
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.loop import closing as j_closing
from sqrtlm_slam_tpu.optim import schur_bucketed as j_sb
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_sb
from sqrtlm_slam_tpu_torch.optim import segment

REL_TOL = 5e-6
MINV_REL_TOL = 5e-5
KITTI00_CUT = dict(n_kf=48, n_lm=9600, obs_per_lm=5, drift=4e-4, radius=80.0 * 48 / 1400)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bench_structure():
    flat, _ = make_ba_problem(seed=0, P=96, L=8192, stereo_frac=0.6, obs_per_landmark=5)
    return j_sb.from_flat(flat, 5)


def _kitti00_cut():
    store, _, _ = j_scale.make_scale_store(**KITTI00_CUT)
    return j_closing.gather_global_problem_bucketed(store)[0]


@pytest.fixture(scope="module", params=["bench", "kitti00_cut"])
def case(request):
    """(JAX problem, port problem, the JAX reductions as float32 tensors)."""
    jp = _bench_structure() if request.param == "bench" else _kitti00_cut()
    red = j_sb.reductions_from_terms(
        jp, j_sb._edge_terms(jp, DEFAULT_CAM, jp.obs_valid, 2.447)[:5])
    return jp, convert.ba_problem(jp), [torch.as_tensor(np.asarray(x)) for x in red]


@pytest.mark.parametrize("mu", [1e-3, 1e-1])
def test_tail_matches_the_jax_packages(case, mu):
    jp, tp, red = case
    want = j_sb._pieces_tail(jp, *[jnp.asarray(x.numpy()) for x in red], jnp.float32(mu),
                             y_bf16=False)
    got = t_sb._pieces_tail(tp, *red, torch.tensor(mu))
    for name in ("S_half", "rhs_corr"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=REL_TOL * np.abs(w).max(), err_msg=name)
    w = np.asarray(want.Minv)
    np.testing.assert_allclose(got.Minv.numpy(), w, rtol=0, atol=MINV_REL_TOL * np.abs(w).max())
    for name in ("U", "bl"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    again = t_sb._pieces_tail(tp, *red, torch.tensor(mu))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_tail_holds_no_pose_by_landmark_tensor(case):
    """The one-hot (L, K, P) and the scatter (P, L, 6, 3) are gone: no
    tensor made by the tail has both a pose and a landmark axis, and none is
    larger than the slot pairs' 6x6 blocks or the dense (6P, 6P) system."""
    _, tp, red = case
    P, L, K = tp.num_poses, tp.num_points, tp.obs_cam.shape[1]
    with _Shapes() as mode:
        t_sb._pieces_tail(tp, *red, torch.tensor(1e-3))
    assert mode.shapes
    assert not [s for s in mode.shapes if P in s and L in s]
    assert max(int(np.prod(s)) for s in mode.shapes) <= max(36 * L * K * (K + 1) // 2,
                                                            (6 * P) ** 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_group_sum_is_index_add_in_data_order(seed):
    """`segment.group_sum` adds each key's rows in their order in the data,
    as the CPU's `index_add_` does: bitwise equal, with rows of no key and
    keys without rows."""
    g = torch.Generator().manual_seed(seed)
    n, num_keys = 5000, 97
    keys = torch.randint(-3, num_keys + 3, (n,), generator=g)
    keep = torch.rand(n, generator=g) > 0.3
    x = torch.randn(n, 7, generator=g)
    got = segment.group_sum(segment.key_groups(keys, num_keys, keep), x.__getitem__)
    ok = keep & (keys >= 0) & (keys < num_keys)
    want = torch.zeros(num_keys, 7).index_add_(0, keys[ok], x[ok])
    assert torch.equal(got, want)
