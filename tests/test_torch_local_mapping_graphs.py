"""Local mapping's graphed programs on the CPU, against the JAX package's
jitted functions (on the card the same names replay captured CUDA graphs:
tests/test_torch_graphs_cuda.py).

  * `triangulation.match_and_triangulate` on two frames of eval/synthetic.py
    (the JAX frames' keypoints and descriptors in both packages): match
    indices exact, accepted points within 1e-4 of their distance, `valid`
    equal except for pairs within 1e-4 of a gate (counted and printed);
  * `local_mapping._project_and_match` on buffers padded to `fuse_cap` and
    `_project_and_match_many` on a chunk of B = 24 neighbours (pad rows: an
    identity pose, no valid keypoint), as the JAX package pads them: match
    indices and `valid` exact, and padded equal to unpadded bit for bit;
  * `LocalMapper.create_new_map_points` and `search_in_neighbors` on copies
    of one JAX run's store (local mapping left out of the run): the
    landmarks created (keypoint pairs exact, positions within 1e-4) and the
    store after the fuse equal the JAX `LocalMapper`'s, the fuse with the
    card's padded shapes and with the CPU's unpadded ones, and every fuse
    call of a run keeps one graph key when padded;
  * the one-sided Jacobi null vector of the DLT against float64 SVD.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import synthetic as j_synth
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu.pipeline import local_mapping as j_lm
from sqrtlm_slam_tpu.pipeline import triangulation as j_tri
from sqrtlm_slam_tpu.pipeline.system import SlamSystem as JSlamSystem
from sqrtlm_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from sqrtlm_slam_tpu.pipeline.tracking import TrackingConfig as JTrackingConfig
from sqrtlm_slam_tpu_torch import convert, utils
from sqrtlm_slam_tpu_torch.pipeline import local_mapping as t_lm
from sqrtlm_slam_tpu_torch.pipeline import triangulation as t_tri
from sqrtlm_slam_tpu_torch.utils import desc_to_torch

CAM = j_synth.DEFAULT_CAM
ORB = j_orb.ORBConfig(max_features=600)
GATE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def frames():
    """Five RGB-D frames of eval/synthetic.py built by the JAX package, with
    their true world -> camera poses."""
    world = j_synth.SyntheticWorld(seed=3, n_points=900)
    poses = j_synth.forward_trajectory(5, step=0.4)
    out = []
    for P in poses:
        img, depth = world.render(P, CAM)
        fr = j_frame.build_frame(jnp.asarray(img), CAM, ORB, depth_img=jnp.asarray(depth))
        out.append((j_se3.SE3(jnp.asarray(P.R), jnp.asarray(P.t)), fr))
    return out


def _sigma2(octave):
    return (1.2 ** (2 * np.asarray(octave))).astype(np.float32)


def _tri_inputs(pose1, f1, pose2, f2):
    k1, k2 = f1.kp, f2.kp
    return [pose1, pose2, CAM, k1.xy, k1.desc, k1.valid, _sigma2(k1.octave),
            k2.xy, k2.desc, k2.valid, _sigma2(k2.octave)], dict(angles1=k1.angle,
                                                                  angles2=k2.angle)


def _to_port(args, kwargs):
    def conv(x):
        if isinstance(x, j_se3.SE3):
            return convert.se3(x)
        if x is CAM:
            return convert.camera(x)
        a = np.asarray(x)
        return desc_to_torch(a, "cpu") if a.dtype == np.uint32 else T(a)

    return [conv(a) for a in args], {k: conv(v) for k, v in kwargs.items()}


def _near_gate(pose1, pose2, xy1, xy2, s2_1, s2_2, X):
    """Rows whose acceptance gates (depth, parallax, reprojection, scale)
    lie within GATE_TOL of their threshold, in float64 from `X`."""
    R1, t1, R2, t2 = (np.asarray(a, np.float64) for a in (pose1.R, pose1.t, pose2.R, pose2.t))
    X = np.asarray(X, np.float64)
    c1, c2 = X @ R1.T + t1, X @ R2.T + t2
    C1, C2 = -R1.T @ t1, -R2.T @ t2
    r1, r2 = X - C1, X - C2
    n1, n2 = np.linalg.norm(r1, axis=-1), np.linalg.norm(r2, axis=-1)

    def proj(c):
        return np.stack([CAM.fx * c[:, 0] / c[:, 2] + CAM.cx,
                         CAM.fy * c[:, 1] / c[:, 2] + CAM.cy], -1)

    with np.errstate(divide="ignore", invalid="ignore"):
        values = [(c1[:, 2], 0.05), (c2[:, 2], 0.05),
                  (np.sum(r1 * r2, -1) / (n1 * n2 + 1e-9), 0.9998),
                  (np.sum((proj(c1) - xy1) ** 2, -1) / s2_1, j_tri.CHI2_MONO),
                  (np.sum((proj(c2) - xy2) ** 2, -1) / s2_2, j_tri.CHI2_MONO),
                  (n1 / np.maximum(n2, 1e-9), 1 / 2.5), (n1 / np.maximum(n2, 1e-9), 2.5)]
        near = np.zeros(len(X), bool)
        for v, thr in values:
            near |= np.abs(v - thr) <= GATE_TOL * max(1.0, abs(thr))
    return near


@pytest.mark.parametrize("pair", [(0, 2), (1, 4)])
def test_match_and_triangulate_equals_the_jax_function(frames, pair):
    (p1, f1), (p2, f2) = frames[pair[0]], frames[pair[1]]
    args, kwargs = _tri_inputs(p1, f1, p2, f2)
    rj = j_tri.match_and_triangulate(*args, **kwargs)
    rt = t_tri.match_and_triangulate(*_to_port(args, kwargs)[0], **_to_port(args, kwargs)[1])
    np.testing.assert_array_equal(rt.idx2.numpy(), np.asarray(rj.idx2))
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    idx = np.asarray(rj.idx2)
    near = _near_gate(p1, p2, np.asarray(f1.kp.xy), np.asarray(f2.kp.xy)[idx],
                      _sigma2(f1.kp.octave), _sigma2(f2.kp.octave)[idx], rj.points_w)
    print(f"pair {pair}: {vj.sum()} accepted, {int(near[vj | vt].sum())} within "
          f"{GATE_TOL} of a gate, {int((vj != vt).sum())} decided otherwise")
    assert vj.sum() > 15
    assert not np.any((vj != vt) & ~near)
    both = vj & vt
    Xj, Xt = np.asarray(rj.points_w)[both], rt.points_w.numpy()[both]
    rel = np.linalg.norm(Xt - Xj, axis=-1) / np.linalg.norm(Xj, axis=-1)
    assert rel.max() <= 1e-4, rel.max()


def test_dlt_null_vector_against_float64_svd():
    """The Jacobi null vector of near-rank-3 4x4 systems (columns scaled as
    pixel rows are) against float64 SVD, and a batch with leading axes
    (the initializer's candidate motions)."""
    rng = np.random.RandomState(0)
    A = rng.normal(size=(2, 500, 4, 4)) * np.array([1e3, 1e3, 1.0, 1e2])
    U, S, Vh = np.linalg.svd(A)
    S[..., 3] *= 1e-5
    A = (U * S[..., None, :]) @ Vh
    want = Vh[..., 3, :]
    got = t_tri._null_vector_4x4(T(A, torch.float32)).double().numpy()
    sign = np.sign(np.sum(got * want, -1, keepdims=True))
    assert np.abs(got * sign - want).max() < 1e-5


def _landmarks(pose0, f0):
    """Landmarks from frame 0's depth keypoints: positions, descriptors,
    normals towards the camera, distance bounds around the distance."""
    kp = f0.kp
    z = np.asarray(f0.depth)
    ok = np.asarray(kp.valid) & (z > 0)
    xy = np.asarray(kp.xy)[ok]
    zc = z[ok]
    pc = np.stack([(xy[:, 0] - CAM.cx) * zc / CAM.fx, (xy[:, 1] - CAM.cy) * zc / CAM.fy, zc], -1)
    R, t = np.asarray(pose0.R), np.asarray(pose0.t)
    pos = ((pc - t) @ R).astype(np.float32)
    C = -R.T @ t
    d = np.linalg.norm(pos - C, axis=-1)
    normal = ((pos - C) / d[:, None]).astype(np.float32)
    desc = np.asarray(kp.desc)[ok]
    valid = np.ones(len(pos), bool)
    valid[::7] = False  # a few culled landmarks inside the buffer
    return (pos, desc, valid, normal, (0.5 * d).astype(np.float32),
            (2.0 * d).astype(np.float32))


def _pad(lms, cap):
    """The JAX package's `lm_buffer` padding to `cap` rows."""
    pos, desc, val, normal, dmin, dmax = lms
    m = len(pos)
    out = [np.zeros((cap, 3), np.float32), np.zeros((cap, 8), np.uint32),
           np.zeros(cap, bool), np.zeros((cap, 3), np.float32), np.zeros(cap, np.float32),
           np.full(cap, np.inf, np.float32)]
    for o, a in zip(out, (pos, desc, val, normal, dmin, dmax)):
        o[:m] = a
    return out


def _port_lms(lms):
    pos, desc, val, normal, dmin, dmax = lms
    return [T(pos), desc_to_torch(desc, "cpu"), T(val), T(normal), T(dmin), T(dmax)]


def test_project_and_match_padded_equals_unpadded_and_the_jax_function(frames):
    lms = _landmarks(*frames[0])
    m = len(lms[0])
    pose, fr = frames[2]
    kp = fr.kp
    kp_args = (np.asarray(kp.xy), np.asarray(kp.desc), np.asarray(kp.valid))
    padded = _pad(lms, 4096)
    rj = j_lm._project_and_match(jnp.asarray(pose.R), jnp.asarray(pose.t),
                                 *map(jnp.asarray, padded), *map(jnp.asarray, kp_args), CAM, 3.0)
    cam = convert.camera(CAM)
    kp_t = (T(kp_args[0]), desc_to_torch(kp_args[1], "cpu"), T(kp_args[2]))
    rp = t_lm._project_and_match(T(pose.R), T(pose.t), *_port_lms(padded), *kp_t, cam, 3.0)
    ru = t_lm._project_and_match(T(pose.R), T(pose.t), *_port_lms(lms), *kp_t, cam, 3.0)
    assert rp.valid.shape == (4096,) and not rp.valid[m:].any()
    for a, b in zip(rp, ru):
        assert torch.equal(a[:m], b)
    np.testing.assert_array_equal(rp.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_array_equal(rp.idx.numpy()[:m], np.asarray(rj.idx)[:m])
    assert rp.valid.sum() > 50


def test_project_and_match_many_in_chunks_of_24_equals_the_jax_function(frames):
    lms = _landmarks(*frames[0])
    m = len(lms[0])
    B, nbs = t_lm.FUSE_BATCH, frames[1:]
    assert B == 24
    n = len(nbs)
    N = np.asarray(nbs[0][1].kp.xy).shape[0]
    bR = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    bt = np.zeros((B, 3), np.float32)
    bxy = np.zeros((B, N, 2), np.float32)
    bdesc = np.zeros((B, N, 8), np.uint32)
    bval = np.zeros((B, N), bool)
    for i, (pose, fr) in enumerate(nbs):
        bR[i], bt[i] = np.asarray(pose.R), np.asarray(pose.t)
        bxy[i], bdesc[i], bval[i] = (np.asarray(fr.kp.xy), np.asarray(fr.kp.desc),
                                     np.asarray(fr.kp.valid))
    padded = _pad(lms, 4096)
    rj = j_lm._project_and_match_many(*map(jnp.asarray, (bR, bt)), *map(jnp.asarray, padded),
                                      *map(jnp.asarray, (bxy, bdesc, bval)), CAM, 3.0)
    cam = convert.camera(CAM)

    def port(k, lm_rows):
        return t_lm._project_and_match_many(
            T(bR[:k]), T(bt[:k]), *lm_rows, T(bxy[:k]),
            desc_to_torch(bdesc[:k].reshape(-1, 8), "cpu").reshape(k, N, 8), T(bval[:k]),
            cam, 3.0)

    vp, ip = port(B, _port_lms(padded))
    vu, iu = port(n, _port_lms(lms))
    assert vp.shape == (B, 4096) and not vp[n:].any() and not vp[:, m:].any()
    assert torch.equal(vp[:n, :m], vu) and torch.equal(ip[:n, :m], iu)
    np.testing.assert_array_equal(vp.numpy()[:n], np.asarray(rj.valid)[:n])
    np.testing.assert_array_equal(ip.numpy()[:n, :m], np.asarray(rj.idx)[:n, :m])
    assert (vp[:n].sum(-1) > 20).all()


# ----------------------------------------------------------------------
# The mapper's calls on one JAX run's store
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_store():
    """The JAX system's store after 10 RGB-D frames, local mapping left out
    (keyframes with their depth landmarks, every other keypoint free)."""
    world = j_synth.SyntheticWorld(seed=3, n_points=900)
    cfg = JSystemConfig(orb=ORB, tracking=JTrackingConfig(init_min_depth_kp=80,
                                                          local_map_capacity=1024,
                                                          kf_max_interval=3),
                        max_keyframes=32, max_landmarks=6000)
    system = JSlamSystem(CAM, cfg)
    system.tracker.new_kf_callback = None
    for P in j_synth.forward_trajectory(10, step=0.3):
        assert system.track_depth(*world.render(P, CAM)) is not None
    assert system.num_keyframes() >= 3
    return system.store


def _mappers(store):
    s_j, s_t = copy.deepcopy(store), copy.deepcopy(store)
    return (s_j, j_lm.LocalMapper(s_j, CAM),
            s_t, t_lm.LocalMapper(s_t, convert.camera(CAM), device="cpu"))


def _landmark_table(store, first):
    """(kf, kp) observation pairs and positions of landmarks >= `first`."""
    ids = np.arange(first, store.num_lm)
    obs = [tuple(sorted((int(k), int(i)) for k, i in zip(store.lm_obs_kf[lm],
                                                       store.lm_obs_idx[lm]) if k >= 0))
           for lm in ids]
    return obs, store.lm_pos[ids]


def test_create_new_map_points_equals_the_jax_mapper(jax_store):
    s_j, m_j, s_t, m_t = _mappers(jax_store)
    kf = s_j.num_kf - 1
    first = s_j.num_lm
    n_j = m_j.create_new_map_points(kf)
    n_t = m_t.create_new_map_points(kf)
    print(f"created {n_j} (JAX) / {n_t} (port) landmarks from keyframe {kf}")
    assert n_j > 20 and n_t == n_j
    obs_j, pos_j = _landmark_table(s_j, first)
    obs_t, pos_t = _landmark_table(s_t, first)
    assert obs_t == obs_j
    rel = np.linalg.norm(pos_t - pos_j, axis=-1) / np.linalg.norm(pos_j, axis=-1)
    assert rel.max() <= 1e-4, rel.max()
    np.testing.assert_array_equal(s_t.kf_obs_lm, s_j.kf_obs_lm)
    np.testing.assert_array_equal([lm for lm, _ in m_t.recent_landmarks],
                                  [lm for lm, _ in m_j.recent_landmarks])


@pytest.mark.parametrize("padded", [False, True])
def test_search_in_neighbors_equals_the_jax_mapper(jax_store, padded):
    """Both packages fuse on copies of the JAX store after the JAX
    triangulation (duplicates of the depth landmarks to merge); the port with
    the buffers padded as on the card (`fuse_cap` landmarks, chunks of 24
    neighbours) and with the rows present (the CPU's default)."""
    s0 = copy.deepcopy(jax_store)
    kf = s0.num_kf - 1
    j_lm.LocalMapper(s0, CAM).create_new_map_points(kf)
    s_j, m_j, s_t, m_t = _mappers(s0)
    assert not m_t._pad_fuse
    m_t._pad_fuse = padded
    reads = utils.host_reads
    fused_j = m_j.search_in_neighbors(kf)
    fused_t = m_t.search_in_neighbors(kf)
    print(f"fused {fused_j} (JAX) / {fused_t} (port) at keyframe {kf}")
    assert fused_j > 0 and fused_t == fused_j
    assert utils.host_reads == reads  # the CPU reads nothing back
    for name in ("lm_valid", "lm_obs_kf", "lm_obs_idx", "lm_n_obs", "kf_obs_lm", "lm_pos",
                 "lm_desc", "lm_normal", "lm_min_dist", "lm_max_dist"):
        np.testing.assert_array_equal(getattr(s_t, name), getattr(s_j, name), err_msg=name)


def test_the_fuse_buffers_keep_one_shape_across_keyframes(jax_store):
    """Every `_project_and_match(_many)` call of `search_in_neighbors` has
    the same cache key whatever the keyframe: one graph serves them all."""
    s_j, _, s_t, m_t = _mappers(jax_store)
    m_t._pad_fuse = True  # the card's shapes
    keys = {"one": set(), "many": set()}
    originals = t_lm._project_and_match, t_lm._project_and_match_many

    def record(name, fn):
        def call(*a, **k):
            keys[name].add(fn.key(*a, **k))
            return fn(*a, **k)
        return call

    t_lm._project_and_match = record("one", originals[0])
    t_lm._project_and_match_many = record("many", originals[1])
    try:
        for kf in range(1, s_t.num_kf):
            m_t.search_in_neighbors(kf)
    finally:
        t_lm._project_and_match, t_lm._project_and_match_many = originals
    assert len(keys["one"]) == 1 and len(keys["many"]) == 1, keys
