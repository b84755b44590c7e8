"""The port's two-view initializer against the JAX package, function by
function and whole.

Inputs are tests/test_initializer.py's three scenes (a general scene that
picks F, a planar one that picks H, a pure rotation that is refused), made
by the JAX package and handed to both packages as numpy. `initialize_two_view`
gets the JAX package's own minimal sets, recomputed from the same key
(`jax.random.split` + masked Gumbel top-k), as `sel_F` / `sel_H`.

Tolerances: the normalization and the F / H banks' scores rtol 1e-4 (97% of
a bank and its winner: a near-degenerate hypothesis scores by cancelling
sums; float32 SVDs from different LAPACK builds give F and H up to sign and
scale, compared at 2e-4 after scaling by the largest entry); the chosen
motion's rotation within 1e-3 rad, its translation direction cosine > 0.9999,
`good` masks equal on >= 99% of the points; `success` and
`used_homography` equal. Candidate order may differ between LAPACK builds
(the sign conventions of the SVD permute them), so motions are compared as
sets, never by index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.factors.reprojection import Camera as JCamera
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.geometry import so3 as j_so3
from sqrtlm_slam_tpu.pipeline import initializer as j_init
from sqrtlm_slam_tpu.pipeline import triangulation as j_tri
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.pipeline import initializer as t_init
from sqrtlm_slam_tpu_torch.pipeline import triangulation as t_tri

CAM = JCamera(fx=220.0, fy=220.0, cx=160.0, cy=120.0)
TCAM = convert.camera(CAM)
KEY = jax.random.PRNGKey(11)


def make_pair(planar=False, n=150, noise=0.3, outlier_frac=0.1):
    """tests/test_initializer.py's scene generator."""
    k1, k2, k3 = jax.random.split(KEY, 3)
    if planar:
        uvw = jax.random.uniform(k1, (n, 2), minval=-5, maxval=5)
        X = jnp.concatenate([uvw, jnp.zeros((n, 1))], -1) + jnp.array([0, 0, 14.0])
        Rp = j_so3.exp(jnp.array([0.3, 0.1, 0.0]))
        X = (X - jnp.array([0, 0, 14.0])) @ Rp.T + jnp.array([0, 0, 14.0])
    else:
        X = jax.random.uniform(k1, (n, 3), minval=-5, maxval=5) + jnp.array([0, 0, 14.0])
    T21 = j_se3.SE3(j_so3.exp(jnp.array([0.02, -0.1, 0.01])), jnp.array([-1.2, 0.05, 0.1]))
    uv1 = CAM.project(X)
    uv2 = CAM.project(j_se3.act(T21, X))
    uv2 = uv2 + jax.random.normal(k2, uv2.shape) * noise
    n_out = int(n * outlier_frac)
    uv2 = uv2.at[:n_out].add(jax.random.normal(k3, (n_out, 2)) * 40.0)
    return uv1, uv2, jnp.ones(n, bool), T21


def rotation_pair():
    X = jax.random.uniform(jax.random.PRNGKey(4), (150, 3), minval=-5, maxval=5) \
        + jnp.array([0, 0, 14.0])
    T21 = j_se3.SE3(j_so3.exp(jnp.array([0.0, -0.08, 0.0])), jnp.zeros(3))
    return CAM.project(X), CAM.project(j_se3.act(T21, X)), jnp.ones(150, bool), T21


# (scene, JAX key of initialize_two_view) as in tests/test_initializer.py.
SCENES = {
    "F": (lambda: make_pair(planar=False), 0),
    "H": (lambda: make_pair(planar=True), 1),
    "rotation": (rotation_pair, 2),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    make, seed = SCENES[request.param]
    uv1, uv2, valid, T21 = make()
    return request.param, seed, uv1, uv2, valid, T21


def jax_sets(key, valid, num_hypotheses=200):
    """initialize_two_view's minimal sets from `key` (its lines 284-290)."""
    kF, kH = jax.random.split(key)

    def sample(k, m):
        g = jax.random.gumbel(k, (num_hypotheses, valid.shape[0]))
        g = jnp.where(valid[None, :], g, -jnp.inf)
        return jax.lax.top_k(g, m)[1]

    return np.asarray(sample(kF, 8)), np.asarray(sample(kH, 4))


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def up_to_scale(a, b):
    """a and b (3, 3) after dividing each by its largest entry (F, H are
    defined up to scale and sign)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return a / a.flat[np.argmax(np.abs(a))], b / b.flat[np.argmax(np.abs(b))]


def test_normalize_matches(scene):
    _, _, uv1, _, valid, _ = scene
    xn_j, T_j = j_init._normalize(uv1, valid)
    xn_t, T_t = t_init._normalize(T(uv1), T(valid, torch.bool))
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=1e-5)


def test_minimal_solvers_match(scene):
    """8-point F and 4-point H on the first JAX minimal sets, equal up to
    sign and scale (batched over 20 sets)."""
    name, seed, uv1, uv2, valid, _ = scene
    sel_F, sel_H = jax_sets(jax.random.PRNGKey(seed), valid)
    x1n, _ = j_init._normalize(uv1, valid)
    x2n, _ = j_init._normalize(uv2, valid)
    Fj = jax.vmap(j_init._eight_point_F)(x1n[sel_F[:20]], x2n[sel_F[:20]])
    Hj = jax.vmap(j_init._four_point_H)(x1n[sel_H[:20]], x2n[sel_H[:20]])
    x1t, x2t = T(x1n), T(x2n)
    Ft = t_init._eight_point_F(x1t[sel_F[:20]], x2t[sel_F[:20]])
    Ht = t_init._four_point_H(x1t[sel_H[:20]], x2t[sel_H[:20]])
    if name == "rotation":
        # No baseline: the 8-point system has a null space of more than one
        # dimension and any vector in it is an answer. The port's F must
        # still satisfy its own minimal sets' constraints.
        A = t_init._f_rows(x1t[sel_F[:20]], x2t[sel_F[:20]]).double()
        F_raw = t_init._null_vector(t_init._f_rows(x1t[sel_F[:20]], x2t[sel_F[:20]]))
        assert float((A @ F_raw.double().reshape(20, 9, 1)).abs().max()) < 1e-4
    else:
        for a, b in zip(Ft.numpy(), np.asarray(Fj)):
            np.testing.assert_allclose(*up_to_scale(a, b), atol=2e-4)
    for a, b in zip(Ht.numpy(), np.asarray(Hj)):
        np.testing.assert_allclose(*up_to_scale(a, b), atol=2e-4)
    # Rank 2 after the projection.
    assert np.all(np.abs(np.linalg.det(Ft.double().numpy())) < 1e-6)


def test_scores_and_masked_fits_match(scene):
    """Both banks' scores and inlier masks on the JAX hypotheses, then the
    refit on the best one's inliers."""
    name, seed, uv1, uv2, valid, _ = scene
    sel_F, sel_H = jax_sets(jax.random.PRNGKey(seed), valid)
    x1n, T1 = j_init._normalize(uv1, valid)
    x2n, T2 = j_init._normalize(uv2, valid)
    F = jnp.einsum("ij,hjk,kl->hil", T2.T, jax.vmap(j_init._eight_point_F)(x1n[sel_F],
                                                                          x2n[sel_F]), T1)
    Hm = jnp.einsum("ij,hjk,kl->hil", jnp.linalg.inv(T2),
                    jax.vmap(j_init._four_point_H)(x1n[sel_H], x2n[sel_H]), T1)
    sF_j, oF_j = jax.vmap(lambda f: j_init._score_F(f, uv1, uv2, valid))(F)
    sH_j, oH_j = jax.vmap(lambda h: j_init._score_H(h, uv1, uv2, valid))(Hm)
    xy1, xy2, v = T(uv1), T(uv2), T(valid, torch.bool)
    sF_t, oF_t = t_init._score_F(T(F), xy1, xy2, v)
    sH_t, oH_t = t_init._score_H(T(Hm), xy1, xy2, v)
    for s_t, s_j in ((sF_t.numpy(), np.asarray(sF_j)), (sH_t.numpy(), np.asarray(sH_j))):
        # A hypothesis from a near-degenerate sample scores by cancelling
        # sums, which the two summation orders round apart: rtol 1e-4 holds
        # on 97% of the bank and on the winner.
        assert np.mean(np.isclose(s_t, s_j, rtol=1e-4, atol=1e-3)) >= 0.97
        assert int(np.argmax(s_t)) == int(np.argmax(s_j))
        np.testing.assert_allclose(s_t.max(), s_j.max(), rtol=1e-4)
    assert np.mean(oF_t.numpy() == np.asarray(oF_j)) >= 0.999
    assert np.mean(oH_t.numpy() == np.asarray(oH_j)) >= 0.999

    inF = np.asarray(oF_j)[int(np.argmax(np.asarray(sF_j)))]
    inH = np.asarray(oH_j)[int(np.argmax(np.asarray(sH_j)))]
    Ff_j = j_init._fit_F_masked(x1n, x2n, jnp.asarray(inF))
    Hf_j = j_init._fit_H_masked(x1n, x2n, jnp.asarray(inH))
    Ff_t = t_init._fit_F_masked(T(x1n), T(x2n), T(inF, torch.bool))
    Hf_t = t_init._fit_H_masked(T(x1n), T(x2n), T(inH, torch.bool))
    np.testing.assert_allclose(*up_to_scale(Hf_t.numpy(), Hf_j), atol=1e-4)
    if name != "rotation":  # without a baseline the F refit is not unique
        np.testing.assert_allclose(*up_to_scale(Ff_t.numpy(), Ff_j), atol=1e-4)


def test_singular_homography_fails_the_gates_without_raising():
    """A degenerate sample gives a singular H: `inv_ex` returns without an
    error check, and the non-finite transfer errors count no inlier, as in
    the JAX package."""
    rng = np.random.RandomState(0)
    xy = torch.as_tensor(rng.rand(50, 2).astype(np.float32) * 300)
    H = torch.tensor([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [0.0, 0.0, 1.0]])  # rank 2
    score, ok = t_init._score_H(H, xy, xy, torch.ones(50, dtype=torch.bool))
    sj, okj = j_init._score_H(jnp.asarray(H.numpy()), jnp.asarray(xy.numpy()),
                              jnp.asarray(xy.numpy()), jnp.ones(50, bool))
    assert not ok.any() and not np.asarray(okj).any()
    assert float(score) == float(sj) == 0.0


def _motion_set(R, t):
    return [(np.asarray(R[k], np.float64), np.asarray(t[k], np.float64)) for k in range(len(R))]


def _same_motion(a, b):
    (Ra, ta), (Rb, tb) = a, b
    dR = np.asarray(j_so3.log(jnp.asarray((Ra @ Rb.T).astype(np.float32))))
    return np.linalg.norm(dR) < 1e-3 and float(ta @ tb) > 0.9999


@pytest.mark.parametrize("name", ["F", "H"])
def test_decompositions_give_the_same_candidate_sets(name):
    """E's 4 and H's 8 (R, t) candidates, as sets (order may differ). The
    pure rotation has no baseline: every decomposition of it is degenerate."""
    uv1, uv2, valid, _ = SCENES[name][0]()
    K = jnp.array([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1.0]])
    x1n, T1 = j_init._normalize(uv1, valid)
    x2n, T2 = j_init._normalize(uv2, valid)
    F = T2.T @ j_init._fit_F_masked(x1n, x2n, valid) @ T1
    Hm = jnp.linalg.inv(T2) @ j_init._fit_H_masked(x1n, x2n, valid) @ T1
    Kt = T(K)
    for (Rj, tj), (Rt, tt) in (
            (j_init._decompose_E(K.T @ F @ K), t_init._decompose_E(Kt.T @ T(F) @ Kt)),
            (j_init._decompose_H(Hm, K), t_init._decompose_H(T(Hm), Kt))):
        cj, ct = _motion_set(Rj, tj), _motion_set(Rt.numpy(), tt.numpy())
        assert len(cj) == len(ct)
        for c in cj:
            assert any(_same_motion(c, d) for d in ct)


def test_check_RT_matches(scene):
    """Cheirality counts, parallax, points and masks of the true motion and
    of a wrong one (t flipped), with the port's batched DLT."""
    name, _, uv1, uv2, valid, T21 = scene
    t = np.asarray(T21.t)
    t = t / max(np.linalg.norm(t), 1e-9)
    Rs = np.stack([np.asarray(T21.R)] * 2).astype(np.float32)
    ts = np.stack([t, -t]).astype(np.float32)
    out_t = t_init._check_RT(T(Rs), T(ts), T(uv1), T(uv2), T(valid, torch.bool), TCAM)
    for k in range(2):
        n_j, par_j, X_j, g_j = j_init._check_RT(jnp.asarray(Rs[k]), jnp.asarray(ts[k]),
                                                uv1, uv2, valid, CAM)
        g_t = out_t[3][k].numpy()
        assert np.mean(g_t == np.asarray(g_j)) >= 0.99
        assert abs(int(out_t[0][k]) - int(n_j)) <= max(1, 0.01 * int(n_j))
        if name != "rotation" and int(n_j) > 50:
            np.testing.assert_allclose(float(out_t[1][k]), float(par_j), rtol=1e-3)
            both = g_t & np.asarray(g_j)
            np.testing.assert_allclose(out_t[2][k].numpy()[both], np.asarray(X_j)[both],
                                       rtol=1e-3, atol=1e-3)


def test_dlt_triangulate_batched_equals_per_candidate():
    """The batched DLT (candidate motions as leading dims) is the loop of
    single-motion calls, and the single call matches the JAX package."""
    rng = np.random.RandomState(3)
    X = rng.rand(40, 3).astype(np.float32) * [4, 4, 2] + [0, 0, 8]
    K = np.array([[220.0, 0, 160], [0, 220, 120], [0, 0, 1]], np.float32)
    P1 = K @ np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P2s = np.stack([K @ np.concatenate([np.eye(3), [[-b], [0.0], [0.0]]], 1)
                    for b in (0.5, 1.0, 1.5)]).astype(np.float32)
    uv1 = (X @ K.T)[:, :2] / X[:, 2:]
    Xc = X - [0.5, 0, 0]
    uv2 = (Xc @ K.T)[:, :2] / Xc[:, 2:]
    batched = t_tri._dlt_triangulate(T(uv1), T(uv2), T(P1), T(P2s))
    for k in range(3):
        single = t_tri._dlt_triangulate(T(uv1), T(uv2), T(P1), T(P2s[k]))
        torch.testing.assert_close(batched[k], single, rtol=0, atol=0)
    j = j_tri._dlt_triangulate(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(P1),
                               jnp.asarray(P2s[0]))
    np.testing.assert_allclose(batched[0].numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_initialize_two_view_matches_on_jax_minimal_sets(scene):
    name, seed, uv1, uv2, valid, T21 = scene
    key = jax.random.PRNGKey(seed)
    res_j = j_init.initialize_two_view(key, uv1, uv2, valid, CAM)
    sel_F, sel_H = jax_sets(key, valid)
    res_t = t_init.initialize_two_view(T(uv1), T(uv2), T(valid, torch.bool), TCAM,
                                       sel_F=torch.as_tensor(sel_F), sel_H=torch.as_tensor(sel_H))
    assert bool(res_t.success) == bool(res_j.success)
    assert bool(res_t.used_homography) == bool(res_j.used_homography)
    assert bool(res_j.success) == (name != "rotation")
    if name != "rotation":
        assert bool(res_j.used_homography) == (name == "H")
    if not bool(res_j.success):
        return
    assert _same_motion((res_t.T_21.R.double().numpy(), res_t.T_21.t.double().numpy()),
                        (np.asarray(res_j.T_21.R, np.float64), np.asarray(res_j.T_21.t, np.float64)))
    g_t, g_j = res_t.good.numpy(), np.asarray(res_j.good)
    assert np.mean(g_t == g_j) >= 0.99
    both = g_t & g_j
    np.testing.assert_allclose(res_t.points_w.numpy()[both], np.asarray(res_j.points_w)[both],
                               rtol=1e-3, atol=1e-3)


def test_initialize_two_view_from_the_ports_generator(scene):
    """Drawing its own minimal sets, the port meets tests/test_initializer.py's
    bars on each scene."""
    name, _, uv1, uv2, valid, T21 = scene
    g = torch.Generator().manual_seed(0)
    res = t_init.initialize_two_view(T(uv1), T(uv2), T(valid, torch.bool), TCAM, generator=g)
    assert bool(res.success) == (name != "rotation")
    if name == "rotation":
        return
    assert bool(res.used_homography) == (name == "H")
    t_true = np.asarray(T21.t) / np.linalg.norm(np.asarray(T21.t))
    cos_t = abs(float(res.T_21.t.numpy() @ t_true))
    dR = np.asarray(j_so3.log(jnp.asarray(res.T_21.R.numpy() @ np.asarray(T21.R).T)))
    assert cos_t > 0.995 and np.linalg.norm(dR) < 0.03
