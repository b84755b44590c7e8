"""Port geometry, factors, losses and matching against the JAX package.

Inputs are made from a seed with numpy and fed to both packages. Geometry
and factor outputs agree at atol 1e-5 (float32 evaluation of the same
formulas, different kernels); matching agrees exactly (integer distances
and argmin/argmax with first-index ties on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.factors import reprojection as j_reproj
from sqrtlm_slam_tpu.frontend import matching as j_matching
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.geometry import so3 as j_so3
from sqrtlm_slam_tpu.optim import loss as j_loss
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.factors import reprojection as t_reproj
from sqrtlm_slam_tpu_torch.frontend import matching as t_matching
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.geometry import so3 as t_so3
from sqrtlm_slam_tpu_torch.optim import loss as t_loss
from sqrtlm_slam_tpu_torch.utils import desc_to_torch

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _T(x):
    return torch.as_tensor(np.array(x, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=atol)


def _tangents(seed, n=64):
    rng = np.random.RandomState(seed)
    xi = rng.randn(n, 6).astype(np.float32) * np.array([1, 1, 1, 0.8, 0.8, 0.8], np.float32)
    xi[:4, 3:] = [[0, 0, 0], [1e-6, 0, 0], [0, 2e-5, -1e-5], [0, 0, 3.1]]  # small / near pi
    return xi


def test_so3_exp_log_hat_match():
    w = _tangents(0)[:, 3:]
    _close(t_so3.exp(_T(w)), j_so3.exp(jnp.asarray(w)))
    R = np.asarray(j_so3.exp(jnp.asarray(w)))
    _close(t_so3.log(_T(R)), j_so3.log(jnp.asarray(R)))
    _close(t_so3.mat_to_quat(_T(R)), j_so3.mat_to_quat(jnp.asarray(R)))
    _close(t_so3.left_jacobian(_T(w)), j_so3.left_jacobian(jnp.asarray(w)))
    _close(t_so3.left_jacobian_inv(_T(w)), j_so3.left_jacobian_inv(jnp.asarray(w)))


def test_se3_ops_match():
    xi, dxi = _tangents(1), _tangents(2) * 0.1
    Tj = j_se3.exp(jnp.asarray(xi))
    Tt = t_se3.exp(_T(xi))
    _close(Tt.R, Tj.R)
    _close(Tt.t, Tj.t)
    _close(t_se3.log(Tt), j_se3.log(Tj))
    rj = j_se3.retract(Tj, jnp.asarray(dxi))
    rt = t_se3.retract(Tt, _T(dxi))
    _close(rt.R, rj.R)
    _close(rt.t, rj.t)
    _close(t_se3.local_delta(rt, Tt), j_se3.local_delta(rj, Tj))
    _close(t_se3.inverse(Tt).t, j_se3.inverse(Tj).t)
    c_t, c_j = t_se3.compose(Tt, rt), j_se3.compose(Tj, rj)
    _close(c_t.R, c_j.R)
    _close(c_t.t, c_j.t)
    pts = np.random.RandomState(3).randn(64, 3).astype(np.float32)
    _close(t_se3.act(Tt, _T(pts)), j_se3.act(Tj, jnp.asarray(pts)))
    one = t_se3.SE3(Tt.R[0], Tt.t[0])
    _close(t_se3.act(one, _T(pts)), j_se3.act(j_se3.SE3(Tj.R[0], Tj.t[0]), jnp.asarray(pts)))
    ident = t_se3.identity()
    _close(ident.R, np.eye(3))


def _edges(seed, n=200):
    rng = np.random.RandomState(seed)
    xi = (rng.randn(n, 6) * [0.3, 0.3, 0.3, 0.05, 0.05, 0.05]).astype(np.float32)
    X = (rng.randn(n, 3) * [4, 2, 3] + [0, 0, 12]).astype(np.float32)
    uvr = (rng.rand(n, 3) * [320, 240, 300]).astype(np.float32)
    uvr[::3, 2] = -1.0
    return xi, X, uvr


def test_reprojection_residuals_and_jacobians_match():
    xi, X, uvr = _edges(4)
    cam_j = j_reproj.Camera(220.0, 221.0, 160.0, 120.0, 44.0)
    cam_t = convert.camera(cam_j)
    Tj, Tt = j_se3.exp(jnp.asarray(xi)), t_se3.exp(_T(xi))
    for got, want in zip(
        t_reproj.stereo_residual_jac(Tt, _T(X), _T(uvr), cam_t),
        j_reproj.stereo_residual_jac(Tj, jnp.asarray(X), jnp.asarray(uvr), cam_j),
    ):
        # Pixel-scale values (~1e2-1e3): compare at atol 1e-5 of their scale.
        _close(got, want, atol=ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))
    for got, want in zip(
        t_reproj.mono_residual_jac(Tt, _T(X), _T(uvr[:, :2]), cam_t),
        j_reproj.mono_residual_jac(Tj, jnp.asarray(X), jnp.asarray(uvr[:, :2]), cam_j),
    ):
        _close(got, want, atol=ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))
    x_c = np.asarray(j_se3.act(Tj, jnp.asarray(X)))
    _close(cam_t.project(_T(x_c)), cam_j.project(jnp.asarray(x_c)), atol=1e-3)


def test_huber_and_gates_match():
    e2 = np.concatenate([np.linspace(0, 20, 101), [1e-14, 5.988, 5.991, 5.994]]).astype(np.float32)
    for got, want in zip(t_loss.huber(2.447)(_T(e2)), j_loss.huber(2.447)(jnp.asarray(e2))):
        _close(got, want)
    assert (t_loss.CHI2_2DOF, t_loss.CHI2_3DOF) == (j_loss.CHI2_2DOF, j_loss.CHI2_3DOF)


# ----------------------------------------------------------------------------
# Matching: exact in every mode
# ----------------------------------------------------------------------------


def _match_inputs(seed, Q=160, T=220):
    rng = np.random.RandomState(seed)
    t_desc = rng.randint(0, 2**32, size=(T, 8), dtype=np.uint64).astype(np.uint32)
    # Queries: noisy copies of shuffled targets (true matches at ~10-60 bits),
    # plus near-duplicates that make ratio/mutual/claim conflicts real.
    src = rng.randint(0, T, Q)
    q_desc = t_desc[src].copy()
    for i in range(Q):
        for _ in range(rng.randint(2, 40)):
            q_desc[i, rng.randint(8)] ^= np.uint32(1 << rng.randint(32))
    q_desc[::7] = q_desc[1::7][: len(q_desc[::7])]
    valid_q = rng.rand(Q) > 0.1
    valid_t = rng.rand(T) > 0.1
    window = rng.rand(Q, T) > 0.3
    window[np.arange(Q), src] = True
    octave_t = rng.randint(0, 8, T).astype(np.int32)
    ang_q = (rng.rand(Q) * 2 * np.pi).astype(np.float32)
    ang_t = (ang_q[np.argsort(src)][:T] if Q >= T else rng.rand(T) * 2 * np.pi).astype(np.float32)
    ang_t[src] = ang_q + 0.1
    return q_desc, t_desc, valid_q, valid_t, window, octave_t, ang_q, ang_t


@pytest.mark.parametrize("mode", [
    dict(mutual=True),
    dict(mutual=False, ratio=0.9),
    dict(mutual="claim", ratio=0.8, octave=True, max_dist=100),
    dict(mutual=True, ratio=0.75, window=False, max_dist=100),
    dict(mutual=True, ratio=0.9, angles=True),
    dict(mutual="claim", window=False),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_descriptors_exact(mode, seed):
    q, t, vq, vt, win, oct_t, aq, at = _match_inputs(seed)
    kw_j, kw_t = {}, {}
    for kw, conv, dconv, bconv in (
        (kw_j, jnp.asarray, jnp.asarray, jnp.asarray),
        (kw_t, _T, lambda d: desc_to_torch(d, "cpu"), torch.as_tensor),
    ):
        kw.update(desc_q=dconv(q), desc_t=dconv(t), valid_q=bconv(vq), valid_t=bconv(vt),
                  mutual=mode["mutual"], ratio=mode.get("ratio"),
                  max_dist=mode.get("max_dist", 50))
        if mode.get("window", True):
            kw["window_mask"] = bconv(win)
        if mode.get("octave"):
            kw["octave_t"] = bconv(oct_t)
        if mode.get("angles"):
            kw["angles"] = (conv(aq), conv(at))
    want = j_matching.match_descriptors(**kw_j)
    got = t_matching.match_descriptors(**kw_t)
    valid = np.asarray(want.valid)
    assert valid.sum() > 5, "scenario must produce matches"
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))


def test_rotation_consistency_exact():
    rng = np.random.RandomState(5)
    aq = (rng.rand(300) * 2 * np.pi).astype(np.float32)
    at = (aq + np.where(rng.rand(300) < 0.7, 0.3, rng.rand(300) * 6)).astype(np.float32)
    valid = rng.rand(300) > 0.2
    want = j_matching._rotation_consistency(jnp.asarray(aq), jnp.asarray(at), jnp.asarray(valid))
    got = t_matching._rotation_consistency(_T(aq), _T(at), torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_predict_octave_and_window_mask_exact():
    rng = np.random.RandomState(6)
    dist = (rng.rand(200) * 60 + 0.5).astype(np.float32)
    max_dist = (rng.rand(200) * 80 + 1).astype(np.float32)
    max_dist[::5] = np.inf
    want = j_matching.predict_octave(jnp.asarray(dist), jnp.asarray(max_dist))
    got = t_matching.predict_octave(_T(dist), _T(max_dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    uv_p = (rng.rand(200, 2) * 300).astype(np.float32)
    uv_k = (rng.rand(150, 2) * 300).astype(np.float32)
    radius = (rng.rand(200) * 30 + 5).astype(np.float32)
    oct_k = rng.randint(0, 8, 150).astype(np.int32)
    gate = np.isfinite(max_dist)
    want = j_matching.projection_window_mask(
        jnp.asarray(uv_p), jnp.asarray(uv_k), jnp.asarray(radius),
        octave_pred=want, octave_kp=jnp.asarray(oct_k), level_slack=2,
        octave_gate=jnp.asarray(gate))
    got = t_matching.projection_window_mask(
        _T(uv_p), _T(uv_k), _T(radius), octave_pred=got, octave_kp=torch.as_tensor(oct_k),
        level_slack=2, octave_gate=torch.as_tensor(gate))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
