"""The monocular initializer, the flat and cg local BA, the flat engine's
global BA and the extrinsic calibration as graphed programs, on the CPU (on
the card the same names replay captured CUDA graphs:
tests/test_torch_graphs_cuda.py; the no-device-read check of each graph is
in tests/test_torch_graphs.py).

  * `geometry/jacobi.py` on the initializer's 9-column systems against
    numpy's float64 SVD: the null vectors of the (8, 9) minimal F and H
    systems within 1e-4 (up to sign) where float32 determines them and no
    further from float64 than float32 LAPACK's elsewhere, the tall masked
    refits (N, 9) and (2N, 9) within 1e-4 and the refit's rank-2 projection
    within 1e-4 of float64's nearest rank-2 matrix; the bank's projections
    of rank 2 within 1e-6 relative, the decompositions' rotations
    orthonormal;
  * the draw split: `initialize_two_view` with a generator gives the bits it
    gives on `ransac.minimal_sets`' sets from a generator of the same seed
    (F's drawn first), and leaves the generator in the same state;
  * padded segment plans: sums within 1e-6 relative of the unpadded ones
    (bit for bit on integer data, whose sums round in no order), every key
    listed, the width a power of two;
  * the facade's three local-BA backends and the flat global BA against the
    JAX facade at tests/test_torch_flat.py's gates (chi2 rtol 5e-2, poses
    atol 5e-3, survivors within 0.5 %);
  * `calibrate_extrinsics` without plane terms against the JAX package
    (within 1e-4, as tests/test_torch_utils.py holds it with them), and the
    presence of the plane terms in its cache key;
  * the cache keys of the flat and cg local-BA graphs over the windows of
    a 32-frame RGB-D run (`Graphed.key`, which needs no card): the windows
    of the run's second half bring no new key, and no graph sees more keys
    than it keeps (`max_entries`), so on the card they replay without a
    capture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.factors import calibration as j_calib
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.optim import facade as j_facade
from sqrtlm_slam_tpu.optim import schur_bucketed as j_sb
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.algorithm import ransac
from sqrtlm_slam_tpu_torch.factors import calibration as t_calib
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.eval import synthetic as t_synthetic
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.optim import facade as t_facade
from sqrtlm_slam_tpu_torch.optim import schur as t_schur
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_sb
from sqrtlm_slam_tpu_torch.optim import segment
from sqrtlm_slam_tpu_torch.pipeline import initializer as t_init
from sqrtlm_slam_tpu_torch.pipeline.local_mapping import LocalMappingConfig
from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
from sqrtlm_slam_tpu_torch.utils import cache

CAM = convert.camera(DEFAULT_CAM)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)
    return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))


def _two_views(n=600, planar=False, seed=0, noise=0.3, outliers=0.1):
    """Matched pixels of two views 1.2 m apart (tests/test_initializer.py's
    motion), normalized as the initializer normalizes them."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-5, 5, (n, 3)) + [0, 0, 14.0]
    if planar:
        X[:, 2] = 14.0 + 0.3 * X[:, 0]
    a = np.array([0.02, -0.1, 0.01])
    th = np.linalg.norm(a)
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    X2 = X @ R.T + [-1.2, 0.05, 0.1]

    def project(P):
        return np.stack([CAM.fx * P[:, 0] / P[:, 2] + CAM.cx,
                         CAM.fy * P[:, 1] / P[:, 2] + CAM.cy], -1)

    uv1, uv2 = project(X), project(X2) + rng.normal(size=(n, 2)) * noise
    uv2[: int(outliers * n)] += rng.normal(size=(int(outliers * n), 2)) * 40.0
    xy1, xy2 = T(uv1, torch.float32), T(uv2, torch.float32)
    valid = torch.ones(n, dtype=torch.bool)
    x1n, _ = t_init._normalize(xy1, valid)
    x2n, _ = t_init._normalize(xy2, valid)
    return xy1, xy2, valid, x1n, x2n


def _null_err(v, A64):
    w = np.linalg.svd(A64)[2][..., -1, :]
    return np.minimum(np.abs(v - w).max(-1), np.abs(v + w).max(-1))


# ----------------------------------------------------------------------
# The Jacobi SVDs of the initializer against float64
# ----------------------------------------------------------------------


@pytest.mark.parametrize("bank", ["F", "H"])
def test_minimal_null_vectors_of_9_columns_against_float64(bank):
    """200 minimal systems, as the banks draw them: 8 points (F) or 4
    points (H, two rows each), (8, 9) either way."""
    _, _, valid, x1n, x2n = _two_views(planar=bank == "H")
    sel = ransac.minimal_sets(valid, 200, torch.Generator().manual_seed(3),
                              k=8 if bank == "F" else 4)
    rows = t_init._f_rows if bank == "F" else t_init._h_rows
    A = rows(x1n[sel], x2n[sel])
    assert A.shape == (200, 8, 9)
    A64 = A.double().numpy()
    err = _null_err(t_init._null_vector(A).reshape(200, 9).numpy(), A64)
    lapack = _null_err(torch.linalg.svd(torch.cat([A, torch.zeros_like(A[:, :1])], 1))[2][
        ..., -1, :].numpy(), A64)
    # Where float32 determines the vector (a gap between the two smallest
    # singular values), within 1e-4; elsewhere no further than LAPACK.
    s = np.linalg.svd(A64, compute_uv=False)
    s9 = np.concatenate([s, np.zeros((200, 1))], -1)  # the (8, 9) null direction
    determined = (s9[:, -2] - s9[:, -1]) > 1e-3 * s9[:, 0]
    assert determined.mean() > 0.75
    assert err[determined].max() < 1e-4, np.sort(err[determined])[-5:]
    assert (err <= lapack + 1e-4).all(), np.sort(err - lapack)[-5:]


@pytest.mark.parametrize("kind", ["F", "H"])
def test_tall_masked_refits_against_float64(kind):
    """The consensus refit's (N, 9) / (2N, 9) systems, masked rows zeroed,
    N = 2000 (a KITTI frame's matches): the null vector within 1e-4 (up to
    sign); the F refit's rank-2 projection within 1e-4 of float64's
    nearest rank-2 matrix."""
    _, _, _, x1n, x2n = _two_views(n=2000, planar=kind == "H", seed=5)
    mask = torch.as_tensor(np.random.RandomState(1).rand(2000) > 0.25)
    if kind == "F":
        A = t_init._f_rows(x1n, x2n) * mask[:, None].float()
    else:
        m = mask.float()
        A = t_init._h_rows(x1n, x2n) * torch.cat([m, m])[:, None]
    A64 = A.double().numpy()
    v = t_init._refit_null_vector(A).reshape(-1).numpy()
    assert _null_err(v, A64) < 1e-4
    if kind == "F":
        F = t_init._fit_F_masked(x1n, x2n, mask).double().numpy()
        w = np.linalg.svd(A64)[2][-1].reshape(3, 3)
        w = w if np.abs(v.reshape(3, 3) - w).max() < np.abs(v.reshape(3, 3) + w).max() else -w
        U, S, Vt = np.linalg.svd(w)
        F64 = U @ np.diag([S[0], S[1], 0.0]) @ Vt
        assert np.abs(F - F64).max() < 1e-4
        assert abs(np.linalg.det(F)) < 1e-6


def test_svd3_rank2_and_decompositions_are_orthonormal():
    """`_rank2` of 200 bank hypotheses: rank 2 within 1e-6 relative; the E
    and H decompositions' rotations orthonormal with det +1 within 1e-5 and
    unit translations."""
    _, _, valid, x1n, x2n = _two_views()
    sel = ransac.minimal_sets(valid, 200, torch.Generator().manual_seed(4), k=8)
    F = t_init._eight_point_F(x1n[sel], x2n[sel]).double().numpy()
    sv = np.linalg.svd(F, compute_uv=False)
    assert (sv[:, 2] < 1e-6 * sv[:, 0]).all()
    K = t_init._K(CAM, x1n)
    E = K.T @ t_init._fit_F_masked(x1n, x2n, valid) @ K
    H = t_init._fit_H_masked(x1n, x2n, valid)
    for R, t in (t_init._decompose_E(E), t_init._decompose_H(H, K)):
        R64, t64 = R.double().numpy(), t.double().numpy()
        np.testing.assert_allclose(R64 @ R64.transpose(0, 2, 1),
                                   np.broadcast_to(np.eye(3), R64.shape), atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R64), 1.0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(t64, axis=-1), 1.0, atol=1e-5)


# ----------------------------------------------------------------------
# The draw split
# ----------------------------------------------------------------------


@pytest.mark.parametrize("planar", [False, True])
def test_drawn_initialization_equals_the_minimal_sets_one(planar):
    xy1, xy2, valid, _, _ = _two_views(planar=planar, seed=2)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = t_init.initialize_two_view(xy1, xy2, valid, CAM, generator=g1)
    sel_F = ransac.minimal_sets(valid, 200, g2, k=8)
    sel_H = ransac.minimal_sets(valid, 200, g2, k=4)
    want = t_init.initialize_two_view(xy1, xy2, valid, CAM, sel_F=sel_F, sel_H=sel_H)
    assert _same_bits(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert bool(got.success) and bool(got.used_homography) == planar


# ----------------------------------------------------------------------
# Padded segment plans
# ----------------------------------------------------------------------


@pytest.mark.parametrize("num_keys", [1, 7, 96])
def test_padded_segment_sums_equal_the_unpadded_ones(num_keys):
    rng = np.random.RandomState(num_keys)
    n = 3000
    keys = torch.as_tensor(rng.randint(-1, num_keys + 1, n))  # some outside [0, num_keys)
    keep = torch.as_tensor(rng.rand(n) > 0.2)
    plain = segment.segment_plan(keys, num_keys, keep=keep)
    padded = segment.segment_plan(keys, num_keys, keep=keep, pad=True)
    width = plain.idx.shape[1]
    assert padded.idx.shape == (num_keys, segment.bucket(width))
    b = segment.bucket(width)
    assert b >= width and b & (b - 1) == 0
    assert torch.equal(padded.keys, torch.arange(num_keys))
    assert _same_bits(padded.groups, plain.groups)
    data = torch.as_tensor(rng.normal(size=(n, 6, 3)).astype(np.float32))
    a, b = segment.segment_sum(padded, data), segment.segment_sum(plain, data)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
    whole = torch.as_tensor(rng.randint(-50, 50, (n, 4)).astype(np.float32))
    assert torch.equal(segment.segment_sum(padded, whole), segment.segment_sum(plain, whole))


# ----------------------------------------------------------------------
# The facade's backends against the JAX facade
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ba_problems():
    flat, _ = make_ba_problem(seed=8, P=8, L=96, stereo_frac=0.5, obs_per_landmark=4)
    b = j_sb.from_flat(flat, 4)
    return b, convert.ba_problem(b)


@pytest.mark.parametrize("backend", ["bucketed", "flat", "cg"])
def test_local_ba_backends_match_the_jax_facade(ba_problems, backend):
    b, tb = ba_problems
    out_j, surv_j, chi2_j = jax.jit(
        lambda p: j_facade.Optimizer(backend).local_bundle_adjustment(p, DEFAULT_CAM))(b)
    out_t, surv_t, chi2_t = t_facade.Optimizer(backend).local_bundle_adjustment(tb, CAM)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t), atol=5e-3)
    assert (surv_t.numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_t.numel()


def test_flat_global_ba_matches_the_jax_facade(ba_problems):
    b, tb = ba_problems
    out_j, surv_j, chi2_j = jax.jit(
        lambda p: j_facade.Optimizer("flat").global_bundle_adjustment(p, DEFAULT_CAM,
                                                                      num_iters=10))(b)
    out_t, surv_t, chi2_t = t_facade.Optimizer("flat").global_bundle_adjustment(tb, CAM,
                                                                                num_iters=10)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t), atol=5e-3)
    assert (surv_t.numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_t.numel()


# ----------------------------------------------------------------------
# The extrinsic calibration
# ----------------------------------------------------------------------


def _calibration_inputs():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    T_true = j_se3.exp(jnp.array([0.05, 0.1, -0.2, -0.02, 0.03, 0.01]))
    p_l = jax.random.normal(k1, (300, 3)) * 6.0
    q_c = j_se3.act(T_true, p_l) + jax.random.normal(k2, (300, 3)) * 1e-3
    valid = np.arange(300) < 280
    return T_true, p_l, q_c, valid


def test_calibration_without_planes_equals_the_jax_package():
    T_true, p_l, q_c, valid = _calibration_inputs()
    want = j_calib.calibrate_extrinsics(j_se3.identity(), p_l, q_c, jnp.asarray(valid))
    got = t_calib.calibrate_extrinsics(t_se3.identity(), T(p_l), T(q_c), T(valid))
    np.testing.assert_allclose(got.T.R.numpy(), np.asarray(want.T.R), atol=1e-4)
    np.testing.assert_allclose(got.T.t.numpy(), np.asarray(want.T.t), atol=1e-4)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3, atol=1e-4)
    err = t_se3.local_delta(got.T, convert.se3(T_true))
    assert float(torch.linalg.norm(err)) < 1e-3


def test_calibration_keys_on_the_plane_terms_and_its_statics():
    _, p_l, q_c, valid = _calibration_inputs()
    args = (t_se3.identity(), T(p_l), T(q_c), T(valid))
    planes = dict(plane_p=T(p_l)[:50], plane_n=torch.zeros(50, 3), plane_d=torch.zeros(50),
                  plane_valid=torch.ones(50, dtype=torch.bool))
    calib = t_calib.calibrate_extrinsics
    keys = {calib.key(*args), calib.key(*args, **planes), calib.key(*args, num_iters=5)}
    assert len(keys) == 3
    assert calib.key(*args) == calib.key(*args, num_iters=10)


@pytest.mark.parametrize("backend", ["flat", "cg"])
def test_local_ba_windows_share_graph_keys(backend, monkeypatch):
    graphs = (t_schur._local_loop_jit,) if backend == "flat" else t_sb.LOCAL_GRAPHS
    keys = {id(g): set() for g in graphs}
    new_keys, per_call = [], []
    call = cache.Graphed.__call__

    def recording(self, *a, **k):
        if id(self) in keys:
            key = self.key(*a, **k)
            if key not in keys[id(self)]:
                keys[id(self)].add(key)
                new_keys.append(key)
        return call(self, *a, **k)

    local_ba = t_facade.Optimizer.local_bundle_adjustment

    def counted(self, *a, **k):
        n = len(new_keys)
        out = local_ba(self, *a, **k)
        per_call.append(len(new_keys) - n)
        return out

    monkeypatch.setattr(cache.Graphed, "__call__", recording)
    monkeypatch.setattr(t_facade.Optimizer, "local_bundle_adjustment", counted)
    cam = t_synthetic.DEFAULT_CAM
    world = t_synthetic.SyntheticWorld(seed=1, n_points=1200)
    cfg = SystemConfig(orb=ORBConfig(max_features=1000),
                       local_mapping=LocalMappingConfig(backend=backend))
    s = SlamSystem(cam, cfg, device="cpu")
    for pose in t_synthetic.forward_trajectory(32, step=0.3):
        assert s.track_depth(*world.render(pose, cam)) is not None
    n_ba = s.local_mapper.num_local_ba
    assert n_ba >= 4 and len(per_call) == n_ba
    assert per_call[0] > 0 and sum(per_call[n_ba // 2:]) == 0, per_call
    assert all(len(keys[id(g)]) <= g.max_entries for g in graphs), per_call

