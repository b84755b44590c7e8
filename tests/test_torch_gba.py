"""Port global BA (kernel K3, the matrix-free CG half) against the JAX package.

On the CPU the port's K3 wrapper runs its plain version (`edge_terms(...)[4]`),
held against the JAX package's Pallas chi2 kernel in interpret mode. The CG
step, the LM loop on it and the whole-map problem gather are held against
the JAX package's XLA path on the same inputs. The CUDA kernel against its
plain version: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import scale as j_scale
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.loop import closing as j_closing
from sqrtlm_slam_tpu.optim import assembly_pallas, schur_bucketed
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import scale as t_scale
from sqrtlm_slam_tpu_torch.loop import closing as t_closing
from sqrtlm_slam_tpu_torch.optim import assembly, facade, segment
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_schur

CAM = convert.camera(DEFAULT_CAM)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problems(seed=0, P=8, L=256, K=4):
    flat, _ = make_ba_problem(seed=seed, P=P, L=L, stereo_frac=0.5, obs_per_landmark=K)
    prob = schur_bucketed.from_flat(flat, K)
    return prob, convert.ba_problem(prob)


# ----------------------------------------------------------------------------
# K3 — residual-only robust chi2
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("robust_delta", [None, 2.447])
def test_chi2_plain_matches_pallas_interpret(robust_delta):
    """K3's plain version vs the TPU kernel in interpret mode at L=256,
    rtol 1e-5 (float32 sums of ~1e3 positive terms in different orders)."""
    prob, tp = _problems(0)
    prob = prob._replace(obs_valid=prob.obs_valid.at[::7, 1].set(False))
    tp = tp._replace(obs_valid=torch.as_tensor(np.asarray(prob.obs_valid)))
    w = prob.obs_inv_sigma2 * prob.obs_valid.astype(jnp.float32)
    with jax.disable_jit():
        pal = assembly_pallas.chi2_sum.__wrapped__(
            prob.pose_R, prob.pose_t, prob.points, prob.obs_cam, prob.obs_uvr, w,
            fx=DEFAULT_CAM.fx, fy=DEFAULT_CAM.fy, cx=DEFAULT_CAM.cx, cy=DEFAULT_CAM.cy,
            bf=DEFAULT_CAM.bf, robust_delta=robust_delta, interpret=True,
        )
    got = t_schur.chi2_only(tp, CAM, tp.obs_valid, robust_delta)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(pal), rtol=1e-5)
    # The plain K3 is the chi2 of the plain K2 on the same inputs.
    w_t = tp.obs_inv_sigma2 * tp.obs_valid.float()
    k2 = assembly.assemble(tp.pose_R, tp.pose_t, ~tp.pose_fixed, tp.points, tp.obs_cam,
                           tp.obs_uvr, w_t, CAM, robust_delta)
    assert float(k2.chi2) == float(got)


def test_chi2_only_matches_jax_xla():
    prob, tp = _problems(6)
    for delta in (None, 2.447):
        want = float(schur_bucketed.chi2_only(prob, DEFAULT_CAM, prob.obs_valid, delta))
        got = float(t_schur.chi2_only(tp, CAM, tp.obs_valid, delta))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_chi2_only_matches_jax_xla_past_the_old_pose_cap():
    """4,608 poses (past the ~4,460 that K3's first design staged per block;
    K3 has no pose cap now) on the bench problem's 14.4 m track, 256
    landmarks of 4 slots: the port's chi2_only within rtol 1e-5 of the JAX
    package's on the same problem."""
    P = 4608
    flat, _ = make_ba_problem(seed=7, P=P, L=256, stereo_frac=0.5, obs_per_landmark=4,
                              spacing=96 * 0.15 / P)
    prob = schur_bucketed.from_flat(flat, 4)
    tp = convert.ba_problem(prob)
    assert tp.num_poses == P
    for delta in (None, 2.447):
        want = float(schur_bucketed.chi2_only(prob, DEFAULT_CAM, prob.obs_valid, delta))
        got = float(t_schur.chi2_only(tp, CAM, tp.obs_valid, delta))
        assert np.isfinite(want) and want > 0
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_chi2_rejects_unknown_device_types():
    with pytest.raises(ValueError):
        z = torch.zeros((1, 3), device="meta")
        assembly.chi2_sum(z, z, z, z, z, z, CAM, None)


# ----------------------------------------------------------------------------
# Fixed-order keyed sums
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_matches_index_add(seed):
    rng = np.random.RandomState(seed)
    n, keys_n = 500, 17
    keys = torch.as_tensor(rng.randint(-2, keys_n + 2, n))
    keep = torch.as_tensor(rng.rand(n) > 0.3)
    data = torch.as_tensor(rng.randn(n, 6)).double()
    plan = segment.segment_plan(keys, keys_n, keep=keep)
    got = segment.segment_sum(plan, data)
    ok = keep & (keys >= 0) & (keys < keys_n)
    want = torch.zeros(keys_n, 6, dtype=torch.float64).index_add_(0, keys[ok], data[ok])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------------
# The CG step and the LM loop on it
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("robust_delta", [None, 2.447])
def test_cg_reduce_and_solve_matches_jax(robust_delta):
    prob, tp = _problems(1)
    mu = 1e-3
    want = schur_bucketed.cg_reduce_and_solve(prob, DEFAULT_CAM, prob.obs_valid, robust_delta,
                                              mu, cg_iters=200, cg_tol=1e-8)
    got = t_schur.cg_reduce_and_solve(tp, CAM, tp.obs_valid, robust_delta,
                                      torch.tensor(mu), cg_iters=200, cg_tol=1e-8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-3)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)


def test_pcg_stops_where_the_while_loop_stops(monkeypatch):
    """The done-mask PCG with host checks every few iterations returns the
    iterate and count of the JAX while loop (forcing term 1e-2)."""
    prob, tp = _problems(2)
    mu = 1e-3
    want = schur_bucketed.cg_reduce_and_solve(prob, DEFAULT_CAM, prob.obs_valid, 2.447, mu,
                                              cg_iters=100, cg_tol=1e-2)
    for every in (1, 3, 10):
        monkeypatch.setattr(t_schur, "PCG_CHECK_EVERY", every)
        got = t_schur.cg_reduce_and_solve(tp, CAM, tp.obs_valid, 2.447, torch.tensor(mu),
                                          cg_iters=100, cg_tol=1e-2)
        assert int(got[5]) == int(want[5])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-4)


def test_ba_iterate_cg_matches_jax():
    """LM on the CG step: accepted counts within 1, chi2 within 5e-2."""
    prob, tp = _problems(3)
    delta = 2.447
    out_j, chi2_j, acc_j = schur_bucketed.ba_iterate_cg(prob, DEFAULT_CAM, prob.obs_valid, 8,
                                                        robust_delta=delta)
    out_t, chi2_t, acc_t = t_schur.ba_iterate_cg(tp, CAM, tp.obs_valid, 8, robust_delta=delta)
    chi2_0 = float(t_schur.chi2_only(tp, CAM, tp.obs_valid, delta))
    assert abs(int(acc_j) - int(acc_t)) <= 1
    assert float(chi2_t) < 0.1 * chi2_0
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t),
                               rtol=5e-2, atol=5e-2)


def test_global_ba_cg_matches_jax():
    prob, tp = _problems(4, P=10, L=384, K=5)
    out_j, surv_j, chi2_j = schur_bucketed.global_ba_cg(prob, DEFAULT_CAM, num_iters=10)
    out_t, surv_t, chi2_t = t_schur.global_ba_cg(tp, CAM, num_iters=10)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    assert (surv_t.numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_t.numel()
    np.testing.assert_allclose(out_t.points.numpy(), np.asarray(out_j.points),
                               rtol=5e-2, atol=5e-2)


def test_facade_cg_backend_and_global_ba():
    prob, tp = _problems(5)
    opt = facade.Optimizer("cg")
    out, surv, chi2 = opt.local_bundle_adjustment(tp, CAM)
    from sqrtlm_slam_tpu.optim import facade as j_facade

    out_j, surv_j, chi2_j = j_facade.Optimizer("cg").local_bundle_adjustment(prob, DEFAULT_CAM)
    np.testing.assert_allclose(float(chi2), float(chi2_j), rtol=5e-2)
    out_g, surv_g, chi2_g = facade.Optimizer("bucketed").global_bundle_adjustment(
        tp, CAM, num_iters=5)
    chi2_0 = float(t_schur.chi2_only(tp, CAM, tp.obs_valid, None))
    assert float(chi2_g) < chi2_0
    assert surv_g.shape == tp.obs_valid.shape


# ----------------------------------------------------------------------------
# Whole-map problem: the scale store, gather, write-back
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scale_stores():
    kw = dict(n_kf=40, n_lm=3000, obs_per_lm=5, drift=4e-4)
    return j_scale.make_scale_store(**kw), t_scale.make_scale_store(**kw)


@pytest.mark.parametrize("n_kf, n_lm", [(40, 3000), (1400, 2000)])
def test_scale_store_matches_jax(scale_stores, n_kf, n_lm):
    """The two packages' scale stores bitwise equal: the fixture's, and at
    KITTI 00's 1,400 keyframes (the drift integrated over every keyframe;
    landmarks cut to 2,000)."""
    if (n_kf, n_lm) == (40, 3000):
        (js, jR, jt), (ts, tR, tt) = scale_stores
    else:
        kw = dict(n_kf=n_kf, n_lm=n_lm, obs_per_lm=5, drift=4e-4)
        (js, jR, jt), (ts, tR, tt) = j_scale.make_scale_store(**kw), \
            t_scale.make_scale_store(**kw)
    np.testing.assert_array_equal(tR, jR)
    np.testing.assert_array_equal(tt, jt)
    for f in ("kf_R", "kf_t", "kf_xy", "kf_uvr", "kf_obs_lm", "lm_pos", "lm_obs_kf",
              "lm_obs_idx", "lm_n_obs", "covis", "parent"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    np.testing.assert_allclose(t_scale.store_ate(ts, tR, tt), j_scale.store_ate(js, jR, jt),
                               rtol=1e-5)


def test_gather_global_problem_matches_jax(scale_stores):
    (js, _, _), (ts, _, _) = scale_stores
    pj, mj = j_closing.gather_global_problem_bucketed(js)
    pt, mt = t_closing.gather_global_problem_bucketed(ts, device="cpu")
    L = pt.num_points  # the JAX gather pads L to 128 lanes; the port does not
    assert L == len(mt[1]) and pj.num_points == -(-L // 128) * 128
    assert not np.asarray(pj.point_valid[L:]).any() and not np.asarray(pj.obs_valid[L:]).any()
    for name in pt._fields:
        want = np.asarray(getattr(pj, name))
        if want.shape[0] == pj.num_points:
            want = want[:L]
        np.testing.assert_array_equal(getattr(pt, name).numpy(), want, err_msg=name)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)


def _close_scale_loop(pkg, n_kf, n_lm):
    """The global-BA-at-scale flow (benchmarks/bench_scale.py): drifted ring
    store, the true loop edge through the essential graph, then global BA.
    Returns the ATE at each stage and the chi2 before and after GBA."""
    kw = dict(n_kf=n_kf, n_lm=n_lm, obs_per_lm=5, drift=4e-4)
    if pkg == "jax":
        from sqrtlm_slam_tpu.geometry import sim3 as j_sim3
        from sqrtlm_slam_tpu.loop import essential_graph as j_eg

        store, tR, tt = j_scale.make_scale_store(**kw)
        ate = j_scale.store_ate
        lc = j_closing.LoopCloser(store, DEFAULT_CAM, cfg=j_closing.LoopClosingConfig(
            edge_cap=16384, gba_iters=10, gba_chunk=5))
        mk = lambda R, t: j_sim3.Sim3(jnp.asarray(1.0), jnp.asarray(R), jnp.asarray(t))
        optimize, gather, chi2 = j_eg.optimize_pose_graph, j_closing.gather_global_problem_bucketed, \
            lambda p: schur_bucketed.chi2_only(p, DEFAULT_CAM, p.obs_valid, None)
    else:
        from sqrtlm_slam_tpu_torch.geometry import sim3 as t_sim3
        from sqrtlm_slam_tpu_torch.loop import essential_graph as t_eg

        store, tR, tt = t_scale.make_scale_store(**kw)
        ate = t_scale.store_ate
        lc = t_closing.LoopCloser(store, CAM, cfg=t_closing.LoopClosingConfig(
            edge_cap=16384, gba_iters=10, gba_chunk=5), device="cpu")
        mk = lambda R, t: t_sim3.Sim3(torch.tensor(1.0), torch.as_tensor(R), torch.as_tensor(t))
        optimize, chi2 = t_eg.optimize_pose_graph, \
            lambda p: t_schur.chi2_only(p, CAM, p.obs_valid, None)
        gather = lambda s: t_closing.gather_global_problem_bucketed(s, device="cpu")
    K = store.num_kf
    R_cl = tR[K - 1] @ tR[0].T
    t_cl = tt[K - 1] - R_cl @ tt[0]
    s1 = np.ones(K, np.float32)
    ates = [ate(store, tR, tt)]
    problem = lc._build_pose_graph(K - 1, 0, mk(R_cl, t_cl), s1, store.kf_R[:K].copy(),
                                   store.kf_t[:K].copy(), s1.copy(), store.kf_R[:K].copy(),
                                   store.kf_t[:K].copy())
    out, _ = optimize(problem, num_iters=30)
    lc._apply_pose_graph(out, K)
    ates.append(ate(store, tR, tt))
    chi0 = float(chi2(gather(store)[0]))
    assert lc.run_global_ba() is True
    ates.append(ate(store, tR, tt))
    return ates, chi0, float(chi2(gather(store)[0]))


def test_essential_graph_and_global_ba_at_reduced_scale_match_jax():
    """400 KFs / 8000 landmarks (the 600 / 1.2e5 cell cut in depth, same
    per-keyframe geometry): ATE falls at each stage in both packages, and
    the port's ATE after each stage is within 1e-3 m of the JAX package's."""
    ates_t, chi0_t, chi1_t = _close_scale_loop("torch", 400, 8000)
    ates_j, _, _ = _close_scale_loop("jax", 400, 8000)
    assert ates_t[0] > ates_t[1] > ates_t[2], ates_t
    assert chi1_t < chi0_t
    np.testing.assert_allclose(ates_t, ates_j, atol=1e-3)
