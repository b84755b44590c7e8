"""The loop correction's programs as the port runs them on the card, one
captured graph per iteration (`utils.cache`), here on the CPU (their eager
bodies) against the JAX package's jitted loops:

  * the essential graph (`optimize_pose_graph`: one Gauss-Newton step a
    graph, replayed `num_iters` times) at 1, 5 and 30 steps, within 1e-3
    (tests/test_torch_loop.py's tolerance), and a run split in two equal
    to the whole run bit for bit (the step is a function of the state and
    the call's plans alone);
  * global BA (`ba_iterate_cg`, `global_ba_cg`; three graphs an LM
    iteration, the PCG's done flag read between chunks of its iterations)
    with the flag read every 10 PCG iterations and with all 100 in one
    chunk: each against the JAX package (chi2 5e-2, accepted iterations
    within 1), and the two bit for bit equal, with and without an early
    stop of the PCG, also through `LoopCloser.run_global_ba`; the PCG reads
    its flag once a chunk;
  * the LiDAR pose graph (`optimize_se3_graph`) at 1 and 20 steps on the
    loop and GNSS graphs of tests/test_torch_lidar_odometry.py: poses 1e-4,
    chi2 1e-3;
  * a graph's cache key follows the TF32 switch (a graph keeps the math
    mode of its capture).

The graphs themselves (captured, replayed, bitwise against eager, memory
over several closures, K3 in two threads): tests/test_torch_graphs_cuda.py.
"""

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.lidar import backend as j_backend
from sqrtlm_slam_tpu.loop import essential_graph as j_eg
from sqrtlm_slam_tpu.optim import schur_bucketed as j_schur
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import scale as t_scale
from sqrtlm_slam_tpu_torch.lidar import backend as t_backend
from sqrtlm_slam_tpu_torch.loop import closing as t_closing
from sqrtlm_slam_tpu_torch.loop import essential_graph as t_eg
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_schur
from sqrtlm_slam_tpu_torch.utils import cache
from tests import test_loop as j_test_loop
from tests.test_torch_lidar_odometry import _graphs as se3_graphs

CAM = convert.camera(DEFAULT_CAM)
DELTA = 2.447


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------------
# Essential graph
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drifted_loop():
    problem, _, _ = j_test_loop.TestEssentialGraph()._make_drifted_loop()
    return problem


@pytest.mark.parametrize("num_iters", [1, 5, 30])
def test_essential_graph_steps_match_jax(drifted_loop, num_iters):
    out_j, chi2_j = j_eg.optimize_pose_graph(drifted_loop, num_iters=num_iters)
    out_t, chi2_t = t_eg.optimize_pose_graph(convert.pose_graph_problem(drifted_loop),
                                             num_iters=num_iters)
    for name in ("s", "R", "t"):
        np.testing.assert_allclose(_np(getattr(out_t, name)), _np(getattr(out_j, name)),
                                   atol=1e-3, err_msg=name)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=0.1, atol=1e-4)


def test_essential_graph_run_split_in_two_equals_the_whole_run(drifted_loop):
    problem = convert.pose_graph_problem(drifted_loop)
    whole, chi2_whole = t_eg.optimize_pose_graph(problem, num_iters=6)
    half, _ = t_eg.optimize_pose_graph(problem, num_iters=3)
    split, chi2_split = t_eg.optimize_pose_graph(half, num_iters=3)
    for name in ("s", "R", "t"):
        assert torch.equal(getattr(split, name), getattr(whole, name)), name
    assert torch.equal(chi2_split, chi2_whole)


# ----------------------------------------------------------------------------
# Global BA: the PCG's read period
# ----------------------------------------------------------------------------

# The PCG's iterations between two reads of its done flag: the default
# (`PCG_CHECK_EVERY`, a replay of `_pcg_chunk_jit` each), and all 100 in one
# chunk (the whole PCG inside one graph, as the JAX package's while_loop).
READ_EVERY = [10, 100]


def _problems(seed, P=8, L=256, K=4):
    flat, _ = make_ba_problem(seed=seed, P=P, L=L, stereo_frac=0.5, obs_per_landmark=K)
    prob = j_schur.from_flat(flat, K)
    return prob, convert.ba_problem(prob)


@pytest.fixture(scope="module")
def lm_problem():
    prob, tp = _problems(3)
    out_j, chi2_j, acc_j = j_schur.ba_iterate_cg(prob, DEFAULT_CAM, prob.obs_valid, 8,
                                                 robust_delta=DELTA)
    return tp, (out_j, float(chi2_j), int(acc_j))


@pytest.mark.parametrize("read_every", READ_EVERY)
def test_ba_iterate_cg_matches_jax_at_each_read_period(monkeypatch, lm_problem, read_every):
    """LM on the CG step: accepted counts within 1, chi2 within 5e-2."""
    monkeypatch.setattr(t_schur, "PCG_CHECK_EVERY", read_every)
    tp, (out_j, chi2_j, acc_j) = lm_problem
    out_t, chi2_t, acc_t = t_schur.ba_iterate_cg(tp, CAM, tp.obs_valid, 8, robust_delta=DELTA)
    chi2_0 = float(t_schur.chi2_only(tp, CAM, tp.obs_valid, DELTA))
    assert abs(acc_j - int(acc_t)) <= 1
    assert float(chi2_t) < 0.1 * chi2_0
    np.testing.assert_allclose(float(chi2_t), chi2_j, rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t),
                               rtol=5e-2, atol=5e-2)


@pytest.fixture(scope="module")
def gba_problem():
    prob, tp = _problems(4, P=10, L=384, K=5)
    out_j, surv_j, chi2_j = j_schur.global_ba_cg(prob, DEFAULT_CAM, num_iters=10)
    return tp, (out_j, np.asarray(surv_j), float(chi2_j))


@pytest.mark.parametrize("read_every", READ_EVERY)
def test_global_ba_cg_matches_jax_at_each_read_period(monkeypatch, gba_problem, read_every):
    monkeypatch.setattr(t_schur, "PCG_CHECK_EVERY", read_every)
    tp, (out_j, surv_j, chi2_j) = gba_problem
    out_t, surv_t, chi2_t = t_schur.global_ba_cg(tp, CAM, num_iters=10)
    np.testing.assert_allclose(float(chi2_t), chi2_j, rtol=5e-2)
    assert (surv_t.numpy() != surv_j).sum() <= 0.005 * surv_t.numel()
    np.testing.assert_allclose(out_t.points.numpy(), np.asarray(out_j.points),
                               rtol=5e-2, atol=5e-2)


def _lm_start(tp):
    dtype = tp.points.dtype
    chi2 = t_schur.chi2_only(tp, CAM, tp.obs_valid, DELTA)
    return (chi2, torch.full((), 1e-3, dtype=dtype), torch.full((), 2.0, dtype=dtype),
            tp.obs_valid, t_schur.pose_plan(tp, tp.obs_valid))


def _first_pcg(tp, cg_iters, chunk=None):
    """The PCG of the first LM iteration, through `chunk` when given."""
    chi2, mu, nu, active, plan = _lm_start(tp)
    head = t_schur._cg_head(tp, active, mu, plan, CAM, DELTA, 1e-2)

    def run(st, k):
        if chunk is not None:
            chunk(k)
        return t_schur._pcg_chunk(head.ctx, head.Mp, tp.obs_cam, tp.pose_fixed, plan, st, k)
    return t_schur._pcg_run(run, head.pcg, cg_iters, t_schur.PCG_CHECK_EVERY)


@pytest.mark.parametrize("early_stop", [True, False])
def test_pcg_read_period_changes_no_bits(monkeypatch, early_stop):
    """One LM iteration with the done flag read every 10 PCG iterations and
    with every iteration in one chunk under the mask: every output bit for
    bit equal. With 100 iterations the PCG stops early (forcing term 1e-2);
    with 7 it runs them all."""
    _, tp = _problems(2)
    chi2, mu, nu, active, plan = _lm_start(tp)
    cg_iters = 100 if early_stop else 7
    n = int(_first_pcg(tp, cg_iters).n)
    assert (0 < n < cg_iters - t_schur.PCG_CHECK_EVERY) if early_stop else n == cg_iters
    got = {}
    for read_every in (t_schur.PCG_CHECK_EVERY, cg_iters):
        monkeypatch.setattr(t_schur, "PCG_CHECK_EVERY", read_every)
        got[read_every] = t_schur._lm_step(tp, chi2, mu, nu, active, plan, CAM, DELTA,
                                           cg_iters, t_schur.GLOBAL_GRAPHS)
    a, b = got.values()
    for name, x, y in zip(t_schur.LMState._fields, a, b):
        assert torch.equal(x, y), name
    assert bool(a.accept)


def test_pcg_reads_its_flag_once_a_chunk(monkeypatch):
    """The PCG reads its done flag before each chunk of `PCG_CHECK_EVERY`
    iterations and stops at the first read after the stop test holds: n
    iterations take ceil(n / 10) chunks and one read more; a PCG that runs
    all its iterations ends without a last read."""
    _, tp = _problems(2)
    reads, chunks, to_host = [], [], t_schur.to_host

    def counted(*xs):
        reads.append(1)
        return to_host(*xs)

    monkeypatch.setattr(t_schur, "to_host", counted)
    s = _first_pcg(tp, 100, chunks.append)
    n = int(s.n)
    assert 0 < n < 90 and bool(s.done)
    assert chunks == [10] * -(-n // 10) and len(reads) == len(chunks) + 1
    reads.clear(), chunks.clear()
    s = _first_pcg(tp, 7, chunks.append)
    assert int(s.n) == 7 and chunks == [7] and len(reads) == 1


def test_run_global_ba_equal_bitwise_at_each_read_period(monkeypatch):
    """`LoopCloser.run_global_ba` (chunks of `gba_chunk` LM iterations) on a
    drifted scale store: the same map bit for bit whether the PCG reads its
    flag every 10 iterations or runs all 100 under the mask, and chi2
    falls."""
    stores = {}
    for read_every in READ_EVERY:
        monkeypatch.setattr(t_schur, "PCG_CHECK_EVERY", read_every)
        # The 600-keyframe ring cut to 48 keyframes at the same step.
        store, _, _ = t_scale.make_scale_store(n_kf=48, n_lm=1000, obs_per_lm=5, drift=4e-4,
                                               radius=80.0 * 48 / 600)
        lc = t_closing.LoopCloser(store, CAM, cfg=t_closing.LoopClosingConfig(
            gba_iters=6, gba_chunk=4), device="cpu")
        p0, _ = t_closing.gather_global_problem_bucketed(store, device="cpu")
        chi2_0 = float(t_schur.chi2_only(p0, CAM, p0.obs_valid, None))
        assert lc.run_global_ba() is True
        p1, _ = t_closing.gather_global_problem_bucketed(store, device="cpu")
        assert float(t_schur.chi2_only(p1, CAM, p1.obs_valid, None)) < chi2_0
        stores[read_every] = store
    for field in ("kf_R", "kf_t", "lm_pos", "lm_obs_kf"):
        np.testing.assert_array_equal(getattr(stores[10], field), getattr(stores[100], field),
                                      err_msg=field)


# ----------------------------------------------------------------------------
# The LiDAR pose graph
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("num_iters", [1, 20])
@pytest.mark.parametrize("case", ["loop", "gnss"])
def test_optimize_se3_graph_steps_match_jax(case, num_iters):
    _, gj, gt = se3_graphs(loop=case == "loop", anchors=case == "gnss")
    out_j, chi2_j = j_backend.optimize_se3_graph(gj, num_iters=num_iters)
    out_t, chi2_t = t_backend.optimize_se3_graph(gt, num_iters=num_iters)
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=1e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=1e-4)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=1e-3, atol=1e-7)


# ----------------------------------------------------------------------------
# The cache key
# ----------------------------------------------------------------------------


def test_graph_key_follows_the_tf32_switch():
    fn = cache.graphed(lambda x: x @ x)
    x = torch.ones(4, 4)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = fn.key(x)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = fn.key(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert off != on and fn.key(x) == (on if prev else off)
