"""Relocalisation and the loop's Sim3 verification as graphed programs, on
the CPU (on the card the same names replay captured CUDA graphs:
tests/test_torch_graphs_cuda.py; the no-device-read check of each graph is
in tests/test_torch_graphs.py).

  * the draw split: uniforms drawn outside a graph, then `top_k_sets`
    (inside) gives `minimal_sets`' bits and the sets the unsplit draw gave,
    at k = 3 and 6; each public entry point called with a generator gives
    the bits it gives on the unsplit draw's sets from a generator of the
    same seed, and leaves the generator in the same state;
  * `geometry/jacobi.py` against numpy's float64 SVD: the 3x3 SVD at full
    rank, rank 2 and rank 1 (singular values, orthonormal U and V, Umeyama's
    rotation orthonormal within 1e-6 with det +1, A rebuilt), the batched
    12-column null vector within 1e-4 (up to sign) where float32 determines
    it and no further from float64 than float32 LAPACK's elsewhere, and the
    tall row-weighted DLT refit within 1e-4;
  * padding: `project_match` on the loop group padded to `loop_points_cap`
    equals the unpadded call bit for bit and the JAX `_project_match_kernel`
    exactly; `guided_sim3_match` equals the JAX `_guided_sim3_kernel`
    exactly; `LoopCloser._project_loop_points` keeps one graph key whatever
    the group's size, and `recover_pose_no_prior` one whatever the frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import synthetic as j_synth
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.loop import closing as j_closing
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.algorithm import pnp, ransac
from sqrtlm_slam_tpu_torch.eval import scale, synthetic
from sqrtlm_slam_tpu_torch.frontend import matching
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.geometry import jacobi, sim3
from sqrtlm_slam_tpu_torch.loop import closing, sim3_solver
from sqrtlm_slam_tpu_torch.pipeline import frame as frame_mod
from sqrtlm_slam_tpu_torch.pipeline import tracking
from sqrtlm_slam_tpu_torch.utils import desc_to_torch

CAM_J = j_synth.DEFAULT_CAM
CAM = convert.camera(CAM_J)


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


# ----------------------------------------------------------------------
# The draw split
# ----------------------------------------------------------------------


def _minimal_sets_before_the_split(valid, num_hypotheses, generator, k):
    """`minimal_sets` as it was before the draw was split."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator,
                   device=valid.device).clamp(min=tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[None, :], g, torch.full_like(g, -float("inf")))
    return torch.topk(g, k, dim=-1).indices


@pytest.mark.parametrize("k", [3, 6])
def test_the_split_draw_equals_minimal_sets(k):
    valid = torch.as_tensor(np.random.RandomState(k).rand(300) > 0.4)
    H = 256
    u = torch.rand((H, 300), generator=torch.Generator().manual_seed(7))
    split = ransac.top_k_sets(u, valid, k)
    assert torch.equal(split, ransac.minimal_sets(valid, H, torch.Generator().manual_seed(7), k))
    assert torch.equal(split, _minimal_sets_before_the_split(
        valid, H, torch.Generator().manual_seed(7), k))
    assert split.shape == (H, k) and bool(valid[split].all())


def _pnp_inputs():
    rng = np.random.RandomState(9)
    n = 200
    X = (rng.uniform(-6, 6, (n, 3)) + [0, 0, 14]).astype(np.float32)
    x_c = X + np.array([0.4, -0.2, 1.0], np.float32)
    uv = np.stack([CAM.fx * x_c[:, 0] / x_c[:, 2] + CAM.cx,
                   CAM.fy * x_c[:, 1] / x_c[:, 2] + CAM.cy], -1).astype(np.float32)
    uv[:60] += rng.normal(size=(60, 2)).astype(np.float32) * 60.0
    valid = np.ones(n, bool)
    valid[150:160] = False
    return T(X), T(x_c), T(uv), T(valid), torch.ones(n)


def _recovery_inputs():
    """A port-built RGB-D frame and a local map from its depth keypoints,
    slightly moved."""
    world = synthetic.SyntheticWorld(seed=3, n_points=900)
    pose = synthetic.forward_trajectory(25, step=0.4)[12]
    img, depth = world.render(pose, synthetic.DEFAULT_CAM)
    f = frame_mod.build_frame(T(img), synthetic.DEFAULT_CAM, ORBConfig(max_features=600),
                              depth_img=T(depth))
    z = f.depth
    pos = torch.stack([(f.kp.xy[:, 0] - CAM.cx) * z / CAM.fx,
                       (f.kp.xy[:, 1] - CAM.cy) * z / CAM.fy, z], -1) + 0.02
    lm = tracking.LocalMapBuffer(ids=None, pos=pos, desc=f.kp.desc, valid=(z > 0) & f.kp.valid,
                                 max_dist=torch.full_like(z, float("inf")))
    return lm, f


def _entry_point_runs(name):
    """(call with a generator, call with the unsplit draw's sets from a
    generator) of one public entry point."""
    if name in ("ransac_pnp_2d3d", "ransac_pose_3d3d"):
        X, x_c, uv, valid, is2 = _pnp_inputs()
        if name == "ransac_pnp_2d3d":
            def run(**kw):
                return pnp.ransac_pnp_2d3d(X, uv, valid, is2, CAM, **kw)
            k = 6
        else:
            def run(**kw):
                return pnp.ransac_pose_3d3d(X, x_c, uv, valid, is2, CAM, **kw)
            k = 3
        return (lambda g: run(generator=g),
                lambda g: run(sel=_minimal_sets_before_the_split(valid, 256, g, k)))
    if name == "ransac_sim3":
        rng = np.random.RandomState(3)
        x2 = T(rng.uniform(-4, 4, (128, 3)) + [0, 0, 12], torch.float32)
        x1 = x2 * 1.05 + T([0.1, 0.0, -0.2], torch.float32)
        x1[:30] += T(rng.normal(size=(30, 3)) * 3.0, torch.float32)
        valid = torch.arange(128) < 120
        is2 = torch.ones(128)
        return (lambda g: sim3_solver.ransac_sim3(x1, x2, valid, is2, is2, CAM, generator=g),
                lambda g: sim3_solver.ransac_sim3(
                    x1, x2, valid, is2, is2, CAM,
                    sel=_minimal_sets_before_the_split(valid, 128, g, 3)))
    lm, f = _recovery_inputs()
    res = matching.match_descriptors(lm.desc, f.kp.desc, lm.valid, f.kp.valid,
                                     max_dist=matching.TH_HIGH, ratio=0.9, mutual=True)
    valid3 = res.valid & (f.depth[res.idx.long()] > 0)

    def with_sets(g):
        sel3 = _minimal_sets_before_the_split(valid3, 256, g, 3)
        sel2 = _minimal_sets_before_the_split(res.valid, 256, g, 6)
        return tracking.recover_pose_no_prior(lm, f, CAM, sel3=sel3, sel2=sel2)

    return (lambda g: tracking.recover_pose_no_prior(lm, f, CAM, generator=g), with_sets)


@pytest.mark.parametrize("name", ["ransac_pnp_2d3d", "ransac_pose_3d3d", "ransac_sim3",
                                  "recover_pose_no_prior"])
def test_entry_points_draw_what_the_unsplit_draw_drew(name):
    drawn, given = _entry_point_runs(name)
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    got, want = drawn(g1), given(g2)
    assert _same_bits(got, want), name
    assert torch.equal(g1.get_state(), g2.get_state())  # the same stream consumed
    assert int(got[-1]) > 0  # the banks found a consensus


# ----------------------------------------------------------------------
# The Jacobi SVDs against float64
# ----------------------------------------------------------------------


def _covariances(rank, n=256, seed=0):
    rng = np.random.RandomState(seed + rank)
    if rank == 3:
        return rng.randn(n, 3, 3)
    if rank == 2:  # minimal sets: three centred points span a plane
        P = rng.randn(n, 3, 3)
        Q = rng.randn(n, 3, 3)
        P -= P.mean(1, keepdims=True)
        Q -= Q.mean(1, keepdims=True)
        return np.einsum("hni,hnj->hij", Q, P)
    a, b = rng.randn(n, 3), rng.randn(n, 3)  # collinear points
    return a[:, :, None] * b[:, None, :]


@pytest.mark.parametrize("rank", [3, 2, 1])
def test_svd3_against_float64(rank):
    A = _covariances(rank).astype(np.float32)
    U, S, V = jacobi.svd3(T(A))
    assert all(bool(torch.isfinite(x).all()) for x in (U, S, V))
    S64 = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    scale_ = np.abs(S64).max(-1, keepdims=True)
    np.testing.assert_allclose(S.numpy() / scale_, S64 / scale_, atol=1e-6)
    assert bool((S[:, :-1] >= S[:, 1:]).all()) and bool((S >= 0).all())
    eye = np.eye(3)
    for M in (U, V):
        M64 = M.double().numpy()
        np.testing.assert_allclose(M64.transpose(0, 2, 1) @ M64, np.broadcast_to(eye, M64.shape),
                                   atol=1e-6)
    rebuilt = (U @ torch.diag_embed(S) @ V.mT).numpy()
    np.testing.assert_allclose(rebuilt / scale_[..., None], A / scale_[..., None], atol=2e-6)
    # Umeyama's rotation: U diag(1, 1, sign det(U V^T)) V^T.
    d = torch.sign(jacobi.det3(U @ V.mT))
    R = (U * torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)[:, None, :]) @ V.mT
    R64 = R.double().numpy()
    np.testing.assert_allclose(R64.transpose(0, 2, 1) @ R64, np.broadcast_to(eye, R64.shape),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(R64), 1.0, atol=1e-6)
    A64 = A.astype(np.float64)
    np.testing.assert_allclose(jacobi.det3(T(A64)).numpy(), np.linalg.det(A64), rtol=1e-9,
                               atol=1e-9)


def _null_err(v, A64):
    w = np.linalg.svd(A64)[2][..., -1, :]
    return np.minimum(np.abs(v - w).max(-1), np.abs(v + w).max(-1))


def _dlt_rows(X, uv, w=None):
    n = len(X)
    Xh = np.c_[X, np.ones(n)]
    z = np.zeros_like(Xh)
    r1 = np.c_[Xh, z, -uv[:, :1] * Xh]
    r2 = np.c_[z, Xh, -uv[:, 1:2] * Xh]
    if w is not None:
        r1, r2 = r1 * w[:, None], r2 * w[:, None]
    return np.r_[r1, r2]


def _resection_scene(n, rng):
    X = rng.uniform(-6, 6, (n, 3)) + [0, 0, 14]
    x_c = X + [0.4, -0.2, 1.0]
    return X, x_c[:, :2] / x_c[:, 2:] + rng.randn(n, 2) * 0.5 / 220.0


def test_null_vector_of_12_columns_against_float64():
    rng = np.random.RandomState(4)
    # A planted null vector: 12 x 12 matrices whose smallest singular value
    # lies well below the next (float32 determines the vector).
    B = rng.randn(256, 12, 12)
    w = rng.randn(256, 12)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    A = (B - np.einsum("hij,hj,hk->hik", B, w, w) + 1e-4 * rng.randn(256, 12, 12))
    A = A.astype(np.float32)
    v = jacobi.null_vector(T(A)).numpy()
    assert _null_err(v, A.astype(np.float64)).max() < 1e-4
    # The bank's 6-point resections: where float32 does not determine the
    # vector (nearly equal smallest values), no further from float64 than
    # float32 LAPACK.
    D = np.stack([_dlt_rows(*_resection_scene(6, rng)) for _ in range(256)]).astype(np.float32)
    err = _null_err(jacobi.null_vector(T(D)).numpy(), D.astype(np.float64))
    lapack = _null_err(torch.linalg.svd(T(D))[2][..., -1, :].numpy(), D.astype(np.float64))
    assert (err <= lapack + 1e-4).all(), np.sort(err - lapack)[-5:]
    assert np.median(err) < 1e-4


def test_null_vector_of_the_tall_weighted_refit_against_float64():
    rng = np.random.RandomState(6)
    X, uv = _resection_scene(2048, rng)
    w = (rng.rand(2048) > 0.3).astype(np.float64)  # the consensus set's 0/1 row weights
    A = _dlt_rows(X, uv, w).astype(np.float32)
    assert A.shape == (4096, 12)
    err = _null_err(jacobi.null_vector(T(A)).numpy(), A.astype(np.float64))
    assert err < 1e-4, err


# ----------------------------------------------------------------------
# The loop's matchers against the JAX package, padded
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_frames():
    """Three RGB-D frames of eval/synthetic.py built by the JAX package,
    with their world -> camera poses."""
    world = j_synth.SyntheticWorld(seed=3, n_points=900)
    orb = j_orb.ORBConfig(max_features=600)
    out = []
    for P in j_synth.forward_trajectory(3, step=0.4):
        img, depth = world.render(P, CAM_J)
        fr = j_frame.build_frame(jnp.asarray(img), CAM_J, orb, depth_img=jnp.asarray(depth))
        out.append((j_se3.SE3(jnp.asarray(P.R), jnp.asarray(P.t)), fr))
    return out


def _group(pose, fr):
    """A loop landmark group from a frame's depth keypoints: world
    positions, descriptors, validity, normals, distance bounds."""
    kp = fr.kp
    z = np.asarray(fr.depth)
    ok = np.asarray(kp.valid) & (z > 0)
    xy = np.asarray(kp.xy)[ok]
    zc = z[ok]
    pc = np.stack([(xy[:, 0] - CAM.cx) * zc / CAM.fx, (xy[:, 1] - CAM.cy) * zc / CAM.fy, zc], -1)
    R, t = np.asarray(pose.R), np.asarray(pose.t)
    pos = ((pc - t) @ R).astype(np.float32)
    C = -R.T @ t
    d = np.linalg.norm(pos - C, axis=-1)
    normal = ((pos - C) / d[:, None]).astype(np.float32)
    valid = np.ones(len(pos), bool)
    valid[::7] = False
    return (pos, np.asarray(kp.desc)[ok], valid, normal, (0.5 * d).astype(np.float32),
            np.minimum(2.0 * d, 1e6).astype(np.float32))


def _pad_group(g, cap):
    """`LoopCloser._project_loop_points`' padding (the JAX package's)."""
    m = len(g[0])
    out = [np.zeros((cap, 3), np.float32), np.zeros((cap, 8), np.uint32), np.zeros(cap, bool),
           np.tile(np.array([0, 0, 1], np.float32), (cap, 1)), np.zeros(cap, np.float32),
           np.full(cap, 1e6, np.float32)]
    for o, a in zip(out, g):
        o[:m] = a
    return out


def _port_group(g):
    pos, desc, val, normal, dmin, dmax = g
    return [T(pos), desc_to_torch(desc, "cpu"), T(val), T(normal), T(dmin), T(dmax)]


@pytest.mark.parametrize("s", [1.0, 1.07])
def test_project_match_padded_equals_unpadded_and_the_jax_kernel(jax_frames, s):
    group = _group(*jax_frames[0])
    m = len(group[0])
    cap = closing.LoopClosingConfig().loop_points_cap
    pose, fr = jax_frames[1]
    # S_cw with scale s: world points scaled about the origin by 1 / s
    # first, so that the keyframe still sees them where it did.
    group = (group[0] / s,) + group[1:4] + (group[4] / s, group[5] / s)
    S_j = (jnp.asarray(s, jnp.float32), jnp.asarray(pose.R), jnp.asarray(pose.t))
    kp = fr.kp
    kp_np = (np.asarray(kp.xy), np.asarray(kp.desc), np.asarray(kp.octave), np.asarray(kp.valid))
    padded = _pad_group(group, cap)
    idx_j, ok_j = j_closing._project_match_kernel(
        CAM_J, *S_j, *map(jnp.asarray, padded), *map(jnp.asarray, kp_np), jnp.float32(10.0))
    S_t = sim3.Sim3(T(s, torch.float32), T(pose.R), T(pose.t))
    kp_t = (T(kp_np[0]), desc_to_torch(kp_np[1], "cpu"), T(kp_np[2], torch.int32), T(kp_np[3]))
    idx_p, ok_p = closing.project_match(CAM, S_t, *_port_group(padded), *kp_t, 10.0)
    idx_u, ok_u = closing.project_match(CAM, S_t, *_port_group(group), *kp_t, 10.0)
    assert ok_p.shape == (cap,) and not bool(ok_p[m:].any())
    assert torch.equal(idx_p[:m], idx_u) and torch.equal(ok_p[:m], ok_u)
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(idx_p.numpy()[:m], np.asarray(idx_j)[:m])
    assert int(ok_p.sum()) > 30  # the comparison covers matches


def test_guided_sim3_match_equals_the_jax_kernel(jax_frames):
    """Two keyframes' keypoint-aligned landmarks (each in its own camera
    frame), S12 their true relative pose."""
    (P1, f1), (P2, f2) = jax_frames[0], jax_frames[1]

    def kp_points(fr):
        z = np.asarray(fr.depth)
        xy = np.asarray(fr.kp.xy)
        ok = np.asarray(fr.kp.valid) & (z > 0)
        x = np.stack([(xy[:, 0] - CAM.cx) * z / CAM.fx, (xy[:, 1] - CAM.cy) * z / CAM.fy, z], -1)
        return np.where(ok[:, None], x, 0.0).astype(np.float32), ok

    x1, v1 = kp_points(f1)
    x2, v2 = kp_points(f2)
    R1, t1, R2, t2 = (np.asarray(a, np.float64) for a in (P1.R, P1.t, P2.R, P2.t))
    R12 = R1 @ R2.T
    t12 = (t1 - R12 @ t2).astype(np.float32)
    args = [(x1, v1, f1.kp.desc, f1.kp.xy, f1.kp.octave),
            (x2, v2, f2.kp.desc, f2.kp.xy, f2.kp.octave)]
    idx_j, agree_j = j_closing._guided_sim3_kernel(
        CAM_J, jnp.float32(1.0), jnp.asarray(R12, jnp.float32), jnp.asarray(t12),
        *[jnp.asarray(np.asarray(a)) for side in args for a in side], jnp.float32(7.5))
    port = []
    for x, v, desc, xy, octave in args:
        port += [T(x), T(v), desc_to_torch(np.asarray(desc), "cpu"), T(np.asarray(xy)),
                 T(np.asarray(octave), torch.int32)]
    S12 = sim3.Sim3(torch.tensor(1.0), T(R12, torch.float32), T(t12))
    idx_t, agree_t = closing.guided_sim3_match(CAM, S12, *port, 7.5)
    np.testing.assert_array_equal(agree_t.numpy(), np.asarray(agree_j))
    sel = np.asarray(agree_j)
    np.testing.assert_array_equal(idx_t.numpy()[sel], np.asarray(idx_j)[sel])
    assert sel.sum() > 50


def test_one_graph_key_per_run(jax_frames):
    """`_project_loop_points` passes groups of any size in one shape, and
    `recover_pose_no_prior` one shape for any frame and local map of a
    configuration: one capture each serves a run."""
    store, _, _ = scale.make_scale_store(n_kf=12, n_lm=3000, obs_per_lm=3, radius=8.0)
    lc = closing.LoopCloser(store, CAM, device="cpu")
    keys, project = [], closing.project_match

    def record(*a, **k):
        keys.append(project.key(*a, **k))
        return project(*a, **k)

    S = sim3.Sim3(torch.tensor(1.0), torch.eye(3), torch.zeros(3))
    closing.project_match = record
    try:
        for n in (40, 900, 3000):
            kp, ok = lc._project_loop_points(3, S, np.arange(n, dtype=np.int64), 10.0)
            assert kp.shape == (n,) and ok.shape == (n,)
    finally:
        closing.project_match = project
    assert len(keys) == 3 and keys[0] == keys[1] == keys[2]

    rkeys, recover = [], tracking._recover_pose_jit

    def record_recover(*a, **k):
        rkeys.append(recover.key(*a, **k))
        return recover(*a, **k)

    lm, f = _recovery_inputs()
    f2 = convert.frame(jax_frames[1][1])
    lm2 = lm._replace(pos=lm.pos * 1.1, valid=lm.valid & (torch.arange(600) % 2 == 0))
    tracking._recover_pose_jit = record_recover
    try:
        for buf, fr in ((lm, f), (lm2, f2)):
            tracking.recover_pose_no_prior(buf, fr, CAM, generator=torch.Generator())
    finally:
        tracking._recover_pose_jit = recover
    assert len(rkeys) == 2 and rkeys[0] == rkeys[1]
