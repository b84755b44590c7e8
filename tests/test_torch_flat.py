"""The flat-edge BA engine (the facade's `flat` backend) and the public
helpers of the port against the JAX package, on the same numpy inputs.

The JAX flat engine is XLA (no Pallas kernel), so both sides run their
plain code on the CPU. Tolerances are stated per test; none is looser than
the JAX package's own gates for the same functions (tests/test_schur_ba.py,
tests/test_facade.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import scale as j_scale
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.factors import reprojection as j_reproj
from sqrtlm_slam_tpu.geometry import align as j_align
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.geometry import so3 as j_so3
from sqrtlm_slam_tpu.loop import closing as j_closing
from sqrtlm_slam_tpu.optim import edge_kernels as j_edge
from sqrtlm_slam_tpu.optim import facade as j_facade
from sqrtlm_slam_tpu.optim import lm as j_lm
from sqrtlm_slam_tpu.optim import loss as j_loss
from sqrtlm_slam_tpu.optim import schur as j_schur
from sqrtlm_slam_tpu.optim import schur_bucketed as j_sb
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import scale as t_scale
from sqrtlm_slam_tpu_torch.factors import reprojection as t_reproj
from sqrtlm_slam_tpu_torch.geometry import align as t_align
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.geometry import so3 as t_so3
from sqrtlm_slam_tpu_torch.loop import closing as t_closing
from sqrtlm_slam_tpu_torch.optim import edge_kernels as t_edge
from sqrtlm_slam_tpu_torch.optim import facade as t_facade
from sqrtlm_slam_tpu_torch.optim import lm as t_lm
from sqrtlm_slam_tpu_torch.optim import loss as t_loss
from sqrtlm_slam_tpu_torch.optim import schur as t_schur
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_sb

CAM = convert.camera(DEFAULT_CAM)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(seed=0, P=8, L=96, K=4, **kw):
    """The JAX package's flat problem and its port twin (one shape for the
    whole file: the JAX generator compiles per shape)."""
    flat, truth = make_ba_problem(seed=seed, P=P, L=L, stereo_frac=0.5, obs_per_landmark=K,
                                  **kw)
    return flat, convert.flat_ba_problem(flat)


_j_reduce_and_solve = jax.jit(j_schur.reduce_and_solve)


@jax.jit
def _j_normal_equations(p):
    return j_schur.build_normal_equations(p, DEFAULT_CAM, p.obs_valid, None)


def _t(x):
    return torch.as_tensor(np.array(x))


# ----------------------------------------------------------------------------
# Small kernels and helpers
# ----------------------------------------------------------------------------


def test_inv3x3_matches_jax():
    """Closed-form 3x3 inverse on SPD blocks (as the engine damps them) and
    on general ones: rtol 1e-5 against the JAX function, and M @ inv = I."""
    rng = np.random.RandomState(0)
    A = rng.randn(200, 3, 3).astype(np.float32)
    spd = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(3, dtype=np.float32)
    for M in (spd, A):
        got = t_edge.inv3x3(_t(M)).numpy()
        np.testing.assert_allclose(got, np.asarray(j_edge.inv3x3(jnp.asarray(M))),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(spd @ t_edge.inv3x3(_t(spd)).numpy(),
                               np.broadcast_to(np.eye(3), spd.shape), atol=1e-4)


@pytest.mark.parametrize("name,arg", [("trivial", None), ("huber", 2.447), ("cauchy", 2.447),
                                      ("tukey", 4.685)])
def test_losses_match_jax(name, arg):
    """rho, rho' and rho'' over inliers, outliers and 0: rtol 1e-6."""
    e2 = np.concatenate([[0.0], np.logspace(-4, 3, 99)]).astype(np.float32)
    args = () if arg is None else (arg,)
    jl, tl = getattr(j_loss, name)(*args), getattr(t_loss, name)(*args)
    for got, want in zip(tl(_t(e2)), jl(jnp.asarray(e2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_reprojection_helpers_match_jax():
    """`transform_points` and the (u, v, depth) factor's residual and
    Jacobians, rtol 1e-5."""
    rng = np.random.RandomState(1)
    w = (rng.randn(50, 6) * 0.1).astype(np.float32)
    T_j = j_se3.exp(jnp.asarray(w))
    T_t = t_se3.exp(_t(w))
    X = (rng.randn(50, 3) * 2 + np.array([0, 0, 10])).astype(np.float32)
    obs = np.concatenate([rng.rand(50, 2) * 300, 10 + rng.randn(50, 1)], -1).astype(np.float32)
    np.testing.assert_allclose(t_reproj.transform_points(T_t, _t(X)).numpy(),
                               np.asarray(j_reproj.transform_points(T_j, jnp.asarray(X))),
                               rtol=1e-5, atol=1e-5)
    got = t_reproj.depth_residual_jac(T_t, _t(X), _t(obs), CAM)
    want = j_reproj.depth_residual_jac(T_j, jnp.asarray(X), jnp.asarray(obs), DEFAULT_CAM)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-4)


@jax.jit
def _jax_helpers(xi, W, noisy, q, est, gt, H, b):
    """The JAX package's helpers on one set of inputs (one compile)."""
    T = j_se3.exp(xi)
    return dict(
        vee=j_so3.vee(W), normalize=j_so3.normalize(noisy), quat_to_mat=j_so3.quat_to_mat(q),
        rt_to_matrix=j_se3.rt_to_matrix(T.R, T.t), adjoint=j_se3.adjoint(T),
        to_quat_trans=j_se3.to_quat_trans(T),
        se3_normalize=j_se3.normalize(j_se3.SE3(noisy, T.t)).R,
        ate_scale=j_align.ate_rmse(est, gt, align_scale=True),
        ate_rigid=j_align.ate_rmse(est, gt, align_scale=False),
        gauss_newton_step=j_lm.gauss_newton_step(H, b))


def test_geometry_and_lm_helpers_match_jax():
    """so3 `vee` / `normalize` / `quat_to_mat`, se3 matrix and quaternion
    packing, `adjoint`, `normalize`, `ate_rmse`, `gauss_newton_step`:
    rtol 1e-5 (1e-4 for the SVD-based alignment and the 6x6 solve)."""
    rng = np.random.RandomState(2)
    xi = (rng.randn(30, 6) * 0.5).astype(np.float32)
    W = rng.randn(30, 3, 3).astype(np.float32)
    Tt = t_se3.exp(_t(xi))
    noisy = (Tt.R.numpy() + rng.randn(30, 3, 3) * 1e-3).astype(np.float32)
    q = rng.randn(30, 4).astype(np.float32)
    est = rng.randn(40, 3).astype(np.float32)
    gt = (1.3 * est @ Tt.R[0].numpy().T + 0.5 + rng.randn(40, 3) * 0.01).astype(np.float32)
    A = rng.randn(6, 6).astype(np.float32)
    H, b = A @ A.T + np.eye(6, dtype=np.float32), rng.randn(6).astype(np.float32)
    want = {k: jax.tree_util.tree_map(np.asarray, v)
            for k, v in _jax_helpers(xi, W, noisy, q, est, gt, H, b).items()}
    M = t_se3.rt_to_matrix(Tt.R, Tt.t)
    v = t_se3.to_quat_trans(Tt)
    got = dict(
        vee=t_so3.vee(_t(W)), normalize=t_so3.normalize(_t(noisy)),
        quat_to_mat=t_so3.quat_to_mat(_t(q)), rt_to_matrix=M, adjoint=t_se3.adjoint(Tt),
        to_quat_trans=v, se3_normalize=t_se3.normalize(t_se3.SE3(_t(noisy), Tt.t)).R,
        ate_scale=t_align.ate_rmse(_t(est), _t(gt), align_scale=True),
        ate_rigid=t_align.ate_rmse(_t(est), _t(gt), align_scale=False),
        gauss_newton_step=t_lm.gauss_newton_step(_t(H), _t(b)))
    for k in want:
        tol = dict(rtol=1e-4, atol=1e-4) if k.startswith(("ate", "gauss")) \
            else dict(rtol=1e-5, atol=1e-5)
        for g, w in zip(jax.tree_util.tree_leaves(got[k]), jax.tree_util.tree_leaves(want[k])):
            np.testing.assert_allclose(np.asarray(g), w, err_msg=k, **tol)
    np.testing.assert_array_equal(t_se3.from_matrix(M).R.numpy(), Tt.R.numpy())
    np.testing.assert_allclose(t_se3.from_quat_trans(v).R.numpy(), Tt.R.numpy(), atol=1e-5)


def test_lm_optimize_result_and_generic_retraction():
    """`lm_optimize` returns an `LMResult`; with an explicit retraction (a
    2-vector NamedTuple on R^2) it minimises a quadratic."""
    from typing import NamedTuple

    class Vec(NamedTuple):
        x: torch.Tensor

    target = torch.tensor([1.0, -2.0])

    def system(p):
        r = p.x - target
        return torch.eye(2), r, torch.sum(r * r)

    res = t_lm.lm_optimize(Vec(torch.zeros(2)), system, lambda p, d: Vec(p.x + d), num_iters=5)
    assert isinstance(res, t_lm.LMResult) and int(res.num_accepted) >= 1
    np.testing.assert_allclose(res.params.x.numpy(), target.numpy(), atol=1e-4)


# ----------------------------------------------------------------------------
# The flat engine
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("robust_delta", [None, 2.447])
def test_build_normal_equations_matches_jax(robust_delta):
    """All six outputs on the same problem (a third of the edges inactive):
    rtol 1e-4 with atol 1e-3 of each output's scale (float32 sums of up to
    a few hundred terms in different orders)."""
    flat, tp = _flat(0)
    active = np.asarray(flat.obs_valid) & (np.arange(flat.obs_valid.shape[0]) % 3 != 0)
    want = jax.jit(lambda p, a: j_schur.build_normal_equations(p, DEFAULT_CAM, a, robust_delta)
                   )(flat, jnp.asarray(active))
    got = t_schur.build_normal_equations(tp, CAM, _t(active), robust_delta)
    names = ("Hpp", "Hll", "W", "bp", "bl", "chi2")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)


def _rel(a, ref) -> float:
    """Relative error of a step, ||a - ref|| / ||ref||."""
    return float(np.linalg.norm(np.asarray(a, np.float64) - ref) / np.linalg.norm(ref))


def _float64(problem):
    """The same problem with float64 pose, landmark and observation fields."""
    return problem._replace(**{k: np.asarray(v, np.float64) for k, v in problem._asdict().items()
                               if np.asarray(v).dtype == np.float32})


def test_reduce_and_solve_matches_jax():
    """One damped Schur step from the same normal equations. In float64 the
    two packages agree to 1e-9: the algebra is the same. In float32 the
    reduced system's condition number (~4e6 here) sets the error, not the
    package: each package's float32 step lies within 1e-2 (relative, in
    norm) of the float64 step, the rtol of tests/test_schur_ba.py's gate on
    the JAX package's own float32 step."""
    mu = 1e-3
    for seed in (1, 2):
        flat, tp = _flat(seed)
        ne = [np.asarray(x, np.float64)
              for x in _j_normal_equations(flat)]
        with jax.enable_x64(True):
            want = [np.asarray(x) for x in _j_reduce_and_solve(
                *[jnp.asarray(x) for x in ne[:5]], flat.pose_fixed, flat.point_valid, mu)]
        assert want[0].dtype == np.float64
        ne64 = [torch.as_tensor(x) for x in ne]
        got = t_schur.reduce_and_solve(*ne64[:5], tp.pose_fixed, tp.point_valid,
                                       torch.tensor(mu, dtype=torch.float64))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-9)
        got32 = t_schur.reduce_and_solve(*[x.float() for x in ne64[:5]], tp.pose_fixed,
                                         tp.point_valid, torch.tensor(mu))
        jax32 = _j_reduce_and_solve(*[jnp.asarray(x, jnp.float32) for x in ne[:5]],
                                         flat.pose_fixed, flat.point_valid, mu)
        for g, j, w in zip(got32, jax32, want):
            assert _rel(g.numpy(), w) < 1e-2 and _rel(j, w) < 1e-2
        assert not got32[0][:2].any()  # the two gauge poses stay


def test_ba_iterate_matches_jax():
    """8 robust LM iterations: accepted counts within 1, chi2 rtol 5e-2,
    poses atol 5e-3 (tests/test_dist_ba.py's LM gates)."""
    flat, tp = _flat(2)
    out_j, chi2_j, acc_j = jax.jit(
        lambda p: j_schur.ba_iterate(p, DEFAULT_CAM, p.obs_valid, 8, 2.447))(flat)
    out_t, chi2_t, acc_t = t_schur.ba_iterate(tp, CAM, tp.obs_valid, 8, 2.447)
    assert abs(int(acc_t) - int(acc_j)) <= 1
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t), atol=5e-3)
    np.testing.assert_allclose(out_t.points.numpy(), np.asarray(out_j.points), atol=2e-2)


def test_local_ba_survivors_match_jax():
    """The two-phase protocol with 20 corrupted edges: the same survivors
    (at most 0.5% of edges differ), every corrupted edge gated out, chi2
    rtol 5e-2."""
    flat, _ = _flat(3)
    uvr = np.array(flat.obs_uvr)
    uvr[:20, :2] += 60.0
    flat = flat._replace(obs_uvr=jnp.asarray(uvr))
    tp = convert.flat_ba_problem(flat)
    out_j, surv_j, st_j = jax.jit(lambda p: j_schur.local_ba(p, DEFAULT_CAM))(flat)
    out_t, surv_t, st_t = t_schur.local_ba(tp, CAM)
    assert not surv_t[:20].any()
    assert (surv_t.numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_t.numel()
    assert int(st_t.num_inlier_edges) == int(surv_t.sum())
    np.testing.assert_allclose(float(st_t.chi2), float(st_j.chi2), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t), atol=5e-3)


def test_global_ba_matches_jax():
    """20 robust iterations, one gauge pose: chi2 rtol 5e-2, poses atol
    5e-3, survivors within 0.5%."""
    flat, tp = _flat(4, n_fixed=1)
    out_j, surv_j, st_j = jax.jit(lambda p: j_schur.global_ba(p, DEFAULT_CAM))(flat)
    out_t, surv_t, st_t = t_schur.global_ba(tp, CAM)
    np.testing.assert_allclose(float(st_t.chi2), float(st_j.chi2), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t), atol=5e-3)
    assert (surv_t.numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_t.numel()


@pytest.mark.parametrize("robust_delta", [None, 2.447])
def test_flat_cg_step_matches_jax(robust_delta):
    """The matrix-free step, tight CG. In float64 the two packages agree to
    1e-7 (CG to 1e-12) and the step solves the dense engine's system; in
    float32 the step lies within 1e-2 (relative, in norm) of the float64
    one and chi2 within rtol 1e-4 of the JAX package's."""
    mu = 1e-3
    flat, tp = _flat(5)
    with jax.enable_x64(True):
        f64 = _float64(flat)
        want = [np.asarray(x) for x in jax.jit(lambda p: j_schur.cg_reduce_and_solve(
            p, DEFAULT_CAM, p.obs_valid, robust_delta, mu, cg_iters=400, cg_tol=1e-12))(
                jax.tree_util.tree_map(jnp.asarray, f64))]
    assert want[0].dtype == np.float64
    t64 = convert.flat_ba_problem(f64)._replace(
        **{k: torch.as_tensor(v) for k, v in f64._asdict().items() if v.dtype == np.float64})
    got = t_schur.cg_reduce_and_solve(t64, CAM, t64.obs_valid, robust_delta,
                                      torch.tensor(mu, dtype=torch.float64), cg_iters=400,
                                      cg_tol=1e-12)
    for i in (0, 1, 2):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=1e-7, atol=1e-7)
    ne = t_schur.build_normal_equations(t64, CAM, t64.obs_valid, robust_delta)
    dense = t_schur.reduce_and_solve(*ne[:5], t64.pose_fixed, t64.point_valid,
                                     torch.tensor(mu, dtype=torch.float64))
    np.testing.assert_allclose(got[0].numpy(), dense[0].numpy(), atol=1e-7)
    got32 = t_schur.cg_reduce_and_solve(tp, CAM, tp.obs_valid, robust_delta,
                                        torch.tensor(mu), cg_iters=200, cg_tol=1e-8)
    assert _rel(got32[0].numpy(), want[0]) < 1e-2 and _rel(got32[1].numpy(), want[1]) < 1e-2
    chi2_j = j_schur.chi2_only(flat, DEFAULT_CAM, flat.obs_valid, robust_delta)
    np.testing.assert_allclose(float(got32[2]), float(chi2_j), rtol=1e-4)


def test_flat_ba_iterate_cg_and_global_ba_cg_match_jax():
    """LM on the flat CG step and the whole-map wrapper: chi2 rtol 5e-2,
    accepted within 1, poses atol 5e-3."""
    flat, tp = _flat(6)
    out_j, chi2_j, acc_j = jax.jit(
        lambda p: j_schur.ba_iterate_cg(p, DEFAULT_CAM, p.obs_valid, 6, 2.447))(flat)
    out_t, chi2_t, acc_t = t_schur.ba_iterate_cg(tp, CAM, tp.obs_valid, 6, 2.447)
    assert abs(int(acc_t) - int(acc_j)) <= 1
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t), atol=5e-3)
    g_j = j_schur.global_ba_cg(flat, DEFAULT_CAM, num_iters=5)
    g_t = t_schur.global_ba_cg(tp, CAM, num_iters=5)
    np.testing.assert_allclose(float(g_t[2].chi2), float(g_j[2].chi2), rtol=5e-2)
    assert (g_t[1].numpy() != np.asarray(g_j[1])).sum() <= 0.005 * g_t[1].numel()


# ----------------------------------------------------------------------------
# Facade and the whole-map gather
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bucketed():
    flat, _ = _flat(7)
    b = j_sb.from_flat(flat, 4)
    return b, convert.ba_problem(b)


def test_bucketed_to_flat_matches_jax(bucketed):
    b, tb = bucketed
    want = j_facade.bucketed_to_flat(b)
    got = t_facade.bucketed_to_flat(tb)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_three_backends_agree_and_flat_matches_jax(bucketed):
    """Local BA through each backend of the port: chi2 under 5% of the
    start (tests/test_facade.py's gate) and within rtol 5e-2 of each other;
    the flat backend's poses within 1e-3 of the bucketed one's
    (test_facade.py's global gate) and of the JAX flat backend's."""
    b, tb = bucketed
    chi2_0 = float(t_sb.chi2_only(tb, CAM, tb.obs_valid, None))
    res = {}
    for backend in t_facade.BACKENDS:
        out, surv, chi2 = t_facade.Optimizer(backend).local_bundle_adjustment(tb, CAM)
        assert tuple(surv.shape) == tuple(tb.obs_valid.shape)
        assert float(chi2) < 0.05 * chi2_0, backend
        res[backend] = (out, surv, float(chi2))
    for backend in ("flat", "cg"):
        np.testing.assert_allclose(res[backend][2], res["bucketed"][2], rtol=5e-2)
    np.testing.assert_allclose(res["flat"][0].pose_t.numpy(), res["bucketed"][0].pose_t.numpy(),
                               rtol=1e-2, atol=1e-3)
    out_j, surv_j, chi2_j = jax.jit(
        lambda p: j_facade.Optimizer("flat").local_bundle_adjustment(p, DEFAULT_CAM))(b)
    np.testing.assert_allclose(res["flat"][0].pose_t.numpy(), np.asarray(out_j.pose_t),
                               rtol=1e-2, atol=1e-3)
    assert (res["flat"][1].numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_j.size
    g_t = t_facade.Optimizer("flat").global_bundle_adjustment(tb, CAM, num_iters=10)
    g_b = t_facade.Optimizer("bucketed").global_bundle_adjustment(tb, CAM, num_iters=10)
    np.testing.assert_allclose(g_t[0].pose_t.numpy(), g_b[0].pose_t.numpy(), rtol=1e-2,
                               atol=1e-3)


def test_flat_and_bucketed_local_ba_agree_in_float64(bucketed):
    """The two engines are the same algebra: in float64 the two-phase local
    BA of each lands on the same poses and landmarks (1e-8) with the same
    survivors. (In float32 the flat engine, which forms W Hll^-1 W^T
    explicitly, lands farther from this optimum than the square-root
    bucketed one: chip_smoke.py phase 16 measures both.)"""
    _, tb = bucketed
    tb64 = tb._replace(**{k: v.double() for k, v in tb._asdict().items()
                          if v.is_floating_point()})
    ob, sb_, cb = t_facade.Optimizer("bucketed").local_bundle_adjustment(tb64, CAM)
    of, sf, cf = t_facade.Optimizer("flat").local_bundle_adjustment(tb64, CAM)
    assert ob.points.dtype == torch.float64 and torch.equal(sb_, sf)
    np.testing.assert_allclose(float(cf), float(cb), rtol=1e-10)
    np.testing.assert_allclose(of.pose_t.numpy(), ob.pose_t.numpy(), atol=1e-8)
    np.testing.assert_allclose(of.points.numpy(), ob.points.numpy(), atol=1e-8)


def test_gather_and_write_back_global_match_jax():
    """The flat whole-map gather equals the JAX package's field by field;
    the same result written back (with a tenth of the edges failing the
    gate) leaves the two stores equal."""
    kw = dict(n_kf=12, n_lm=400, obs_per_lm=5, drift=4e-4)
    (js, _, _), (ts, _, _) = j_scale.make_scale_store(**kw), t_scale.make_scale_store(**kw)
    pj, mj = j_closing.gather_global_problem(js)
    pt, mt = t_closing.gather_global_problem(ts, device="cpu")
    for name in pj._fields:
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                      err_msg=name)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
    out_j, surv_j, _ = jax.jit(lambda p: j_schur.global_ba(p, DEFAULT_CAM, num_iters=3))(pj)
    surv = np.asarray(surv_j) & (np.arange(surv_j.shape[0]) % 10 != 0)
    j_closing.write_back_global(js, out_j, jnp.asarray(surv), mj)
    t_closing.write_back_global(ts, convert.flat_ba_problem(out_j), _t(surv), mt)
    for f in ("kf_R", "kf_t", "lm_pos", "lm_obs_kf", "lm_obs_idx", "lm_n_obs", "kf_obs_lm"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    assert int(ts.lm_n_obs.sum()) < int(t_scale.make_scale_store(**kw)[0].lm_n_obs.sum())
