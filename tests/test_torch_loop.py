"""Port loop closing (Sim3, alignment, pose graph, vocabulary, place
recognition, Sim3 RANSAC, essential graph, LoopCloser) against the JAX package.

Every test feeds the same numpy inputs to both packages and states its
tolerance. Descriptors come from JAX frames through `convert.py` (the ORB
descriptor residual of tests/test_torch_frontend.py is kept out of these
comparisons). RANSAC draws cannot be reproduced across `jax.random` and
`torch`, so `ransac_sim3` is compared on JAX's own minimal sets (`sel`), and
the end-to-end comparisons hold decisions and refined transforms, not draws.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import synthetic as j_synth
from sqrtlm_slam_tpu.factors import pose_graph as j_pg
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.frontend import vocab as j_vocab
from sqrtlm_slam_tpu.geometry import align as j_align
from sqrtlm_slam_tpu.geometry import sim3 as j_sim3
from sqrtlm_slam_tpu.loop import closing as j_closing
from sqrtlm_slam_tpu.loop import database as j_database
from sqrtlm_slam_tpu.loop import essential_graph as j_eg
from sqrtlm_slam_tpu.loop import sim3_solver as j_solver
from sqrtlm_slam_tpu.mapstore import MapStore
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.algorithm import ransac as t_ransac
from sqrtlm_slam_tpu_torch.factors import pose_graph as t_pg
from sqrtlm_slam_tpu_torch.frontend import vocab as t_vocab
from sqrtlm_slam_tpu_torch.geometry import align as t_align
from sqrtlm_slam_tpu_torch.geometry import sim3 as t_sim3
from sqrtlm_slam_tpu_torch.loop import closing as t_closing
from sqrtlm_slam_tpu_torch.loop import database as t_database
from sqrtlm_slam_tpu_torch.loop import essential_graph as t_eg
from sqrtlm_slam_tpu_torch.loop import sim3_solver as t_solver
from sqrtlm_slam_tpu_torch.utils import desc_to_numpy, desc_to_torch
from tests.test_gba_interrupt import populated_store
from tests import test_loop as j_test_loop
from tests.test_loop_gate import two_cluster_store

CAM_J = j_synth.DEFAULT_CAM
CAM = convert.camera(CAM_J)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sim3_close(got, want, atol):
    for a, b, name in zip(got, want, ("s", "R", "t")):
        np.testing.assert_allclose(_np(a), _np(b), rtol=atol, atol=atol, err_msg=name)


# ----------------------------------------------------------------------------
# Sim(3), alignment, the pose-graph factor
# ----------------------------------------------------------------------------


def _tangents7(seed, n=64):
    """Random sim(3) tangents, with rows in every small-angle / small-scale
    branch of the W matrix."""
    rng = np.random.RandomState(seed)
    xi = rng.randn(n, 7) * np.array([1.0, 1.0, 1.0, 0.6, 0.6, 0.6, 0.2])
    xi[:8, 3:6] *= 1e-7  # theta ~ 0
    xi[8:16, 6] *= 1e-7  # sigma ~ 0
    xi[16:20, 3:7] *= 1e-7  # both
    return xi.astype(np.float32)


def test_sim3_ops_match():
    xa, xb = _tangents7(0), _tangents7(1)
    pts = np.random.RandomState(2).randn(64, 3).astype(np.float32) * 5
    A_j, B_j = j_sim3.exp(jnp.asarray(xa)), j_sim3.exp(jnp.asarray(xb))
    A_t, B_t = t_sim3.exp(torch.as_tensor(xa)), t_sim3.exp(torch.as_tensor(xb))
    _sim3_close(A_t, A_j, 1e-5)
    _sim3_close(t_sim3.compose(A_t, B_t), j_sim3.compose(A_j, B_j), 1e-5)
    _sim3_close(t_sim3.inverse(A_t), j_sim3.inverse(A_j), 1e-5)
    _sim3_close(t_sim3.retract(A_t, torch.as_tensor(xb * 0.1)),
                j_sim3.retract(A_j, jnp.asarray(xb * 0.1)), 1e-5)
    np.testing.assert_allclose(_np(t_sim3.act(A_t, torch.as_tensor(pts))),
                               _np(j_sim3.act(A_j, jnp.asarray(pts))), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(t_sim3.log(A_t)), _np(j_sim3.log(A_j)), rtol=1e-5,
                               atol=1e-5)
    T_t, T_j = t_sim3.to_se3(A_t), j_sim3.to_se3(A_j)
    np.testing.assert_allclose(_np(T_t.t), _np(T_j.t), rtol=1e-5, atol=1e-5)
    # One Sim3 acting on a point cloud (the loop-correction landmark warp).
    np.testing.assert_allclose(
        _np(t_sim3.act(t_sim3.index(A_t, 3), torch.as_tensor(pts))),
        _np(j_sim3.act(jax.tree_util.tree_map(lambda a: a[3], A_j), jnp.asarray(pts))),
        rtol=1e-5, atol=1e-4)
    I = t_sim3.identity((4,))
    np.testing.assert_array_equal(_np(I.R), np.tile(np.eye(3), (4, 1, 1)))


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_batched_weighted_matches(with_scale):
    rng = np.random.RandomState(3)
    H, N = 16, 20
    S = j_sim3.exp(jnp.asarray(_tangents7(4, H)))
    src = (rng.randn(H, N, 3) * 3 + [0, 0, 12]).astype(np.float32)
    dst = np.asarray(j_sim3.act(S, jnp.asarray(src))) + rng.randn(H, N, 3).astype(np.float32) * 0.01
    w = (rng.rand(H, N) > 0.2).astype(np.float32)
    want = j_align.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           with_scale=with_scale)
    got = t_align.umeyama(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w),
                          with_scale=with_scale)
    _sim3_close(got, want, 1e-4)
    T = t_align.se3_horn(torch.as_tensor(src), torch.as_tensor(dst))
    T_j = j_align.se3_horn(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(_np(T.R), _np(T_j.R), atol=1e-4)
    np.testing.assert_allclose(_np(T.t), _np(T_j.t), atol=1e-4)


def test_pose_graph_residual_and_jacobians_match():
    S_i = j_sim3.exp(jnp.asarray(_tangents7(5, 48)))
    S_j = j_sim3.exp(jnp.asarray(_tangents7(6, 48)))
    meas = j_eg.measure_edges(
        jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]), S_i, S_j),
        jnp.arange(48), jnp.arange(48, 96))
    # Half the edges carry their own measurement (r = 0), half a perturbed one.
    meas = j_sim3.retract(meas, jnp.asarray(_tangents7(7, 48) * 0.05)
                          * (jnp.arange(48) % 2)[:, None])
    r_j, Ji_j, Jj_j = j_pg.sim3_relative_residual_jac(S_i, S_j, meas)
    c = lambda S: convert.sim3(S)
    r_t, Ji_t, Jj_t = t_pg.sim3_relative_residual_jac(c(S_i), c(S_j), c(meas))
    np.testing.assert_allclose(_np(r_t), _np(r_j), atol=1e-4)
    np.testing.assert_allclose(_np(Ji_t), _np(Ji_j), atol=1e-4)
    np.testing.assert_allclose(_np(Jj_t), _np(Jj_j), atol=1e-4)
    np.testing.assert_allclose(_np(t_pg.sim3_relative_residual(c(S_i), c(S_j), c(meas))),
                               _np(r_j), atol=1e-4)


# ----------------------------------------------------------------------------
# Vocabulary, BoW, the keyframe database
# ----------------------------------------------------------------------------

# Ring frames at the start of the loop and the frames that re-traverse it
# (`ring_trajectory(160, frac=1.3)`: frame i + 123 revisits frame i).
FRAMES_A = (0, 2, 4, 6, 8, 10)
FRAMES_B = (123, 125, 127, 129, 131, 133)


@pytest.fixture(scope="module")
def ring_frames():
    world = j_synth.ring_world(seed=7, n_points=2500)
    poses = j_synth.ring_trajectory(160, frac=1.3)
    cfg = j_orb.ORBConfig(max_features=600)
    out = []
    for i in FRAMES_A + FRAMES_B:
        img, depth = world.render(poses[i], CAM_J)
        fr = j_frame.build_frame_jit(jnp.asarray(img), CAM_J, cfg, depth_img=jnp.asarray(depth))
        out.append((np.asarray(poses[i].R), np.asarray(poses[i].t), jax.device_get(fr)))
    return out


@pytest.fixture(scope="module")
def vocabs():
    return j_vocab.load_default(), t_vocab.load_default(device="cpu")


def test_shipped_vocabulary_loads_identically(vocabs):
    jv, tv = vocabs
    assert tv.k == jv.k and tv.depth == jv.depth and tv.num_words == jv.num_words
    for a, b in zip(tv.centroids, jv.centroids):
        np.testing.assert_array_equal(desc_to_numpy(a), np.asarray(b))
    np.testing.assert_array_equal(_np(tv.idf), np.asarray(jv.idf))
    np.testing.assert_array_equal(
        desc_to_numpy(convert.vocabulary(jv).centroids[-1]), np.asarray(jv.centroids[-1]))


def test_assign_words_exact_and_bow_vector_match(ring_frames, vocabs):
    jv, tv = vocabs
    for _, _, fr in ring_frames[:4]:
        desc, valid = np.asarray(fr.kp.desc), np.asarray(fr.kp.valid)
        w_j = np.asarray(j_vocab.assign_words(jv, jnp.asarray(desc), jnp.asarray(valid)))
        w_t = t_vocab.assign_words(tv, desc_to_torch(desc, "cpu"), torch.as_tensor(valid))
        np.testing.assert_array_equal(_np(w_t), w_j)
        b_j = np.asarray(j_vocab.bow_vector(jv, jnp.asarray(w_j)))
        b_t = _np(t_vocab.bow_vector(tv, w_t))
        np.testing.assert_allclose(b_t, b_j, rtol=1e-6, atol=1e-6)
    M = np.stack([np.asarray(j_vocab.bow_vector(jv, j_vocab.assign_words(
        jv, fr.kp.desc, fr.kp.valid))) for _, _, fr in ring_frames])
    np.testing.assert_allclose(_np(t_vocab.l1_score(torch.as_tensor(M[0]), torch.as_tensor(M))),
                               np.asarray(j_vocab.l1_score(jnp.asarray(M[0]), jnp.asarray(M))),
                               rtol=1e-6, atol=1e-6)
    wq = np.random.RandomState(0).randint(-1, 1000, 300).astype(np.int32)
    wt = np.random.RandomState(1).randint(-1, 1000, 200).astype(np.int32)
    for up in (0, 1):
        np.testing.assert_array_equal(
            _np(t_vocab.bow_window_mask(torch.as_tensor(wq), torch.as_tensor(wt), up)),
            np.asarray(j_vocab.bow_window_mask(jnp.asarray(wq), jnp.asarray(wt), up)))


def test_vocabulary_training_matches():
    rng = np.random.RandomState(0)
    d = rng.randint(0, 2**32, size=(400, 8), dtype=np.uint64).astype(np.uint32)
    want = j_vocab.train(d, k=4, depth=2, iters=3, seed=1)
    got = t_vocab.train(d, k=4, depth=2, iters=3, seed=1, device="cpu")
    for a, b in zip(got.centroids, want.centroids):
        np.testing.assert_array_equal(desc_to_numpy(a), np.asarray(b))
    np.testing.assert_allclose(_np(got.idf), np.asarray(want.idf), rtol=1e-6)


def test_keyframe_database_is_the_jax_packages_database():
    """The port carries the numpy KeyFrameDatabase so it runs without the
    JAX package; the two must stay identical."""
    assert (inspect.getsource(t_database.KeyFrameDatabase)
            == inspect.getsource(j_database.KeyFrameDatabase))
    assert inspect.getsource(t_database._l1_scores) == inspect.getsource(j_database._l1_scores)


# ----------------------------------------------------------------------------
# Sim3 RANSAC and refinement
# ----------------------------------------------------------------------------


def _sim3_matches(seed, N=128, fix_scale=False):
    rng = np.random.RandomState(seed)
    xi = _tangents7(seed + 10, 1)[0] * np.array([1, 1, 1, 0.5, 0.5, 0.5, 1], np.float32)
    if fix_scale:
        xi[6] = 0.0
    S = j_sim3.exp(jnp.asarray(xi))
    x2 = (rng.uniform(-4, 4, (N, 3)) + [0, 0, 12]).astype(np.float32)
    x1 = np.array(j_sim3.act(S, jnp.asarray(x2)))
    x1[: N // 4] += rng.randn(N // 4, 3).astype(np.float32) * 5.0  # 25% outliers
    valid = np.arange(N) < N - 6
    is2 = (1.0 / 1.2 ** (2 * rng.randint(0, 4, N))).astype(np.float32)
    return S, x1, x2, valid, is2


@pytest.mark.parametrize("fix_scale", [False, True])
def test_ransac_sim3_on_jax_minimal_sets_matches(fix_scale):
    S, x1, x2, valid, is2 = _sim3_matches(0, fix_scale=fix_scale)
    key = jax.random.PRNGKey(3)
    H = 128
    res_j = j_solver.ransac_sim3(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                 jnp.asarray(is2), jnp.asarray(is2), CAM_J, num_hypotheses=H,
                                 fix_scale=fix_scale)
    # JAX's own minimal sets, drawn exactly as inside ransac_sim3.
    g = jnp.where(jnp.asarray(valid)[None, :], jax.random.gumbel(key, (H, len(x1))), -jnp.inf)
    sel = np.asarray(jax.lax.top_k(g, 3)[1])
    T = lambda a: torch.as_tensor(a)
    res_t = t_solver.ransac_sim3(T(x1), T(x2), T(valid), T(is2), T(is2), CAM,
                                 fix_scale=fix_scale, sel=T(sel))
    _sim3_close(res_t.S12, res_j.S12, 1e-3)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 1
    assert (_np(res_t.inliers) != np.asarray(res_j.inliers)).sum() <= 1
    # Without `sel`, an explicit generator draws the sets (distinct, valid).
    gen = torch.Generator().manual_seed(0)
    sets = t_ransac.minimal_sets(T(valid), 64, gen)
    assert sets.shape == (64, 3) and valid[_np(sets)].all()
    assert all(len(set(r)) == 3 for r in _np(sets).tolist())
    res_r = t_solver.ransac_sim3(T(x1), T(x2), T(valid), T(is2), T(is2), CAM,
                                 fix_scale=fix_scale, generator=gen)
    _sim3_close(res_r.S12, res_j.S12, 1e-3)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches(fix_scale):
    S, x1, x2, valid, is2 = _sim3_matches(1, N=96, fix_scale=fix_scale)
    S0 = j_sim3.retract(S, jnp.asarray([0.1, -0.1, 0.05, 0.02, -0.02, 0.01,
                                        0.0 if fix_scale else 0.02]))
    want = j_solver.optimize_sim3(S0, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                  jnp.asarray(is2), jnp.asarray(is2), CAM_J, fix_scale=fix_scale)
    T = lambda a: torch.as_tensor(a)
    got = t_solver.optimize_sim3(convert.sim3(S0), T(x1), T(x2), T(valid), T(is2), T(is2), CAM,
                                 fix_scale=fix_scale)
    _sim3_close(got[0], want[0], 1e-3)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


# ----------------------------------------------------------------------------
# Essential graph
# ----------------------------------------------------------------------------


def test_optimize_pose_graph_on_drifted_loop_matches():
    problem, true_poses, _ = j_test_loop.TestEssentialGraph()._make_drifted_loop()
    out_j, chi2_j = j_eg.optimize_pose_graph(problem, num_iters=30)
    out_t, chi2_t = t_eg.optimize_pose_graph(convert.pose_graph_problem(problem), num_iters=30)
    for name in ("s", "R", "t"):
        np.testing.assert_allclose(_np(getattr(out_t, name)), _np(getattr(out_j, name)),
                                   atol=1e-3, err_msg=name)
    assert float(chi2_t) < 1.0
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=0.1, atol=1e-4)
    S = t_eg.measure_edges(out_t.poses(), out_t.e_i, out_t.e_j)
    S_j = j_eg.measure_edges(out_j.poses(), out_j.e_i, out_j.e_j)
    _sim3_close(S, S_j, 1e-3)


# ----------------------------------------------------------------------------
# LoopCloser on the JAX package's test stores
# ----------------------------------------------------------------------------


def _true_s12(store, kf_cur, kf_loop, dt=(0.0, 0.0, 0.0)):
    R = store.kf_R[kf_cur] @ store.kf_R[kf_loop].T
    t = store.kf_t[kf_cur] - R @ store.kf_t[kf_loop] + np.asarray(dt, np.float32)
    return j_sim3.Sim3(jnp.asarray(1.0), jnp.asarray(R), jnp.asarray(t))


def _gate_store(kind):
    if kind == "two_cluster":
        return two_cluster_store()
    store = populated_store(K=12, L=80)
    for k in range(12):
        store.update_connections(k)
    return store


@pytest.mark.parametrize("kind,dt,committed", [
    ("populated", (30.0, 0.0, 0.0), False),  # drift veto
    ("populated", (0.03, 0.0, 0.0), True),  # honest
    ("two_cluster", (2.6, 0.0, 0.0), False),  # tear veto with rollback
    ("two_cluster", (0.0, 0.0, 0.0), True),  # honest
])
def test_correct_loop_same_decision_and_poses(kind, dt, committed):
    js, ts = _gate_store(kind), _gate_store(kind)
    pre = {f: getattr(ts, f).copy() for f in ("kf_R", "kf_t", "lm_pos", "lm_obs_kf", "covis")}
    cfg_j = j_closing.LoopClosingConfig(run_gba=False)
    lc_j = j_closing.LoopCloser(js, CAM_J, cfg=cfg_j)
    lc_t = t_closing.LoopCloser(ts, CAM, cfg=convert.loop_closing_config(cfg_j), device="cpu")
    S = _true_s12(js, 11, 0, dt)
    assert lc_j.correct_loop(11, 0, S) is committed
    assert lc_t.correct_loop(11, 0, convert.sim3(S)) is committed
    assert lc_t.num_loops_closed == lc_j.num_loops_closed
    assert lc_t.num_loops_rejected == lc_j.num_loops_rejected
    assert (lc_t.last_loop_veto or (None,))[0] == (lc_j.last_loop_veto or (None,))[0]
    assert ts.loop_edges == js.loop_edges
    if committed:
        # Poses after the essential graph.
        np.testing.assert_allclose(ts.kf_R, js.kf_R, atol=1e-3)
        np.testing.assert_allclose(ts.kf_t, js.kf_t, atol=1e-3)
        np.testing.assert_allclose(ts.lm_pos, js.lm_pos, atol=1e-3)
    else:
        for f, v in pre.items():
            np.testing.assert_array_equal(getattr(ts, f), v, err_msg=f)


def _gba_store():
    store = populated_store()
    store.kf_t[3] += np.array([0.05, -0.04, 0.03], np.float32)
    return store


def test_run_global_ba_matches_jax():
    js, ts = _gba_store(), _gba_store()
    cfg = j_closing.LoopClosingConfig(gba_iters=4, gba_chunk=2)
    assert j_closing.LoopCloser(js, CAM_J, cfg=cfg).run_global_ba() is True
    lc = t_closing.LoopCloser(ts, CAM, cfg=convert.loop_closing_config(cfg), device="cpu")
    assert lc.run_global_ba() is True and lc.num_gba_completed == 1
    assert np.linalg.norm(ts.kf_t[3] - np.array([0, 0, -1.2])) < 0.02
    np.testing.assert_allclose(ts.kf_t, js.kf_t, atol=1e-3)
    np.testing.assert_allclose(ts.lm_pos, js.lm_pos, atol=1e-3)
    np.testing.assert_array_equal(ts.lm_obs_kf, js.lm_obs_kf)


def test_gba_abort_leaves_map_untouched():
    ts = _gba_store()
    pre = {f: getattr(ts, f).copy() for f in ("kf_R", "kf_t", "lm_pos", "lm_obs_kf")}
    lc = t_closing.LoopCloser(ts, CAM, cfg=t_closing.LoopClosingConfig(gba_iters=4,
                                                                        gba_chunk=2),
                              device="cpu")
    lc._gba_tick = lambda: setattr(lc, "gba_generation", lc.gba_generation + 1)
    assert lc.run_global_ba() is False and lc.num_gba_aborted == 1
    for f, v in pre.items():
        np.testing.assert_array_equal(getattr(ts, f), v, err_msg=f)


def test_gba_propagates_to_keyframes_created_meanwhile():
    ts = populated_store()
    ts.kf_t[5] += np.array([0.06, 0.05, -0.04], np.float32)
    lc = t_closing.LoopCloser(ts, CAM, cfg=t_closing.LoopClosingConfig(gba_iters=4,
                                                                        gba_chunk=2),
                              device="cpu")
    added = {}

    def tick():
        if added:
            return
        n = ts.feats_per_kf
        R, t = np.eye(3, dtype=np.float32), np.array([0.1, 0, -2.4], np.float32)
        k = ts.add_keyframe(R=R, t=t, xy=np.zeros((n, 2), np.float32),
                            uvr=np.full((n, 3), -1, np.float32), depth=np.zeros(n, np.float32),
                            desc=np.zeros((n, 8), np.uint32), angle=np.zeros(n, np.float32),
                            octave=np.zeros(n, np.int32), kp_valid=np.zeros(n, bool),
                            frame_id=99)
        ts.parent[k] = 5
        added.update(kf=k, rel_R=R @ ts.kf_R[5].T)
        added["rel_t"] = t - added["rel_R"] @ ts.kf_t[5]

    lc._gba_tick = tick
    assert lc.run_global_ba() is True
    k = added["kf"]
    rel_R = ts.kf_R[k] @ ts.kf_R[5].T
    np.testing.assert_allclose(rel_R, added["rel_R"], atol=1e-5)
    np.testing.assert_allclose(ts.kf_t[k] - rel_R @ ts.kf_t[5], added["rel_t"], atol=1e-4)


def test_async_gba_thread_and_generation_bump():
    ts = _gba_store()
    lc = t_closing.LoopCloser(ts, CAM, cfg=t_closing.LoopClosingConfig(gba_iters=2,
                                                                        gba_chunk=1),
                              device="cpu")
    lc.async_gba = True
    lc.gba_generation += 1
    import threading

    lc._gba_thread = threading.Thread(target=lc.run_global_ba, args=(lc.gba_generation,))
    lc._gba_thread.start()
    lc.wait_gba()
    assert lc.num_gba_completed == 1
    assert lc.run_global_ba(generation=lc.gba_generation - 1) is False


# ----------------------------------------------------------------------------
# Detection and Sim3 verification on real descriptors and words
# ----------------------------------------------------------------------------


def _ring_store(ring_frames, voc_j):
    """Two groups of keyframes at the same place of the ring (its start, and
    its re-traversal 123 frames later), each a covisibility cluster with
    landmarks from depth at the true poses and observations found by
    projection + descriptor distance; no landmark is shared across groups."""
    store = MapStore(max_keyframes=32, max_landmarks=8000, feats_per_kf=600,
                     num_words=voc_j.num_words)
    n_a = len(FRAMES_A)
    for start, stop in ((0, n_a), (n_a, len(ring_frames))):
        group_lms = []
        for k in range(start, stop):
            R, t, fr = ring_frames[k]
            kp = fr.kp
            valid = np.asarray(kp.valid)
            words = j_vocab.assign_words(voc_j, kp.desc, kp.valid)
            bow = np.asarray(j_vocab.bow_vector(voc_j, words))
            kf = store.add_keyframe(
                R=R, t=t, xy=np.asarray(kp.xy), uvr=np.asarray(fr.uvr),
                depth=np.asarray(fr.depth), desc=np.asarray(kp.desc),
                angle=np.asarray(kp.angle), octave=np.asarray(kp.octave), kp_valid=valid,
                words=np.asarray(words), bow=bow, frame_id=k)
            store.parent[kf] = kf - 1
            xy = np.asarray(kp.xy)
            taken = np.zeros(len(valid), bool)
            if group_lms:
                lms = np.asarray(group_lms)
                x_c = store.lm_pos[lms] @ R.T + t
                uv = np.stack([CAM_J.fx * x_c[:, 0] / x_c[:, 2] + CAM_J.cx,
                               CAM_J.fy * x_c[:, 1] / x_c[:, 2] + CAM_J.cy], -1)
                d = np.linalg.norm(uv[:, None] - xy[None], axis=-1)
                x = store.lm_desc[lms][:, None] ^ np.asarray(kp.desc)[None]
                ham = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
                ok = (d < 3.0) & (ham < 64) & valid[None] & (x_c[:, 2:3] > 0)
                for i in np.argsort(np.where(ok, d, np.inf).min(1)):
                    cand = np.where(ok[i] & ~taken)[0]
                    if len(cand):
                        j = cand[np.argmin(d[i, cand])]
                        store.add_observation(int(lms[i]), kf, int(j))
                        taken[j] = True
            depth = np.asarray(fr.depth)
            new = np.where(valid & (depth > 0) & ~taken)[0][:250]
            for j in new:
                z = depth[j]
                x_cam = np.array([(xy[j, 0] - CAM_J.cx) * z / CAM_J.fx,
                                  (xy[j, 1] - CAM_J.cy) * z / CAM_J.fy, z], np.float32)
                lm = store.add_landmark(R.T @ (x_cam - t), np.asarray(kp.desc)[j], kf)
                store.add_observation(lm, kf, int(j))
                group_lms.append(lm)
        for k in range(start, stop):
            store.update_connections(k)
    store.update_landmark_stats(np.arange(store.num_lm))
    return store


def test_detect_loop_and_compute_sim3_on_real_descriptors(ring_frames, vocabs):
    jv, tv = vocabs
    base = _ring_store(ring_frames, jv)
    n_a = len(FRAMES_A)
    assert base.covis[:n_a, n_a:].max() == 0  # the two groups share no landmark
    cfg = j_closing.LoopClosingConfig(kf_gap=n_a)
    lc_j = j_closing.LoopCloser(copy.deepcopy(base), CAM_J, voc=jv, cfg=cfg)
    lc_t = t_closing.LoopCloser(copy.deepcopy(base), CAM, voc=tv,
                                cfg=convert.loop_closing_config(cfg), device="cpu")
    found = None
    for q in range(n_a, base.num_kf):
        c_j, c_t = lc_j.detect_loop(q), lc_t.detect_loop(q)
        assert c_t == c_j, (q, c_t, c_j)
        if c_t and found is None:
            found = (q, c_t[0])
    assert found is not None, "no loop candidate reached consistency 3"
    q, c = found
    assert c < n_a
    ok_j, S_j, m_j = lc_j.compute_sim3(q, c)
    ok_t, S_t, m_t = lc_t.compute_sim3(q, c)
    assert ok_j and ok_t, (lc_j.last_reject, lc_t.last_reject)
    # Different RANSAC draws, same refined transform: the true relative pose.
    S_true = _true_s12(base, q, c)
    _sim3_close(S_t, S_j, 2e-2)
    _sim3_close(S_t, S_true, 5e-2)
    assert abs(m_t.n_total - m_j.n_total) <= 0.1 * m_j.n_total
    np.testing.assert_array_equal(m_t.loop_lms, m_j.loop_lms)


# ----------------------------------------------------------------------------
# The ring loop end to end (both packages; long)
# ----------------------------------------------------------------------------


@pytest.mark.slow
def test_ring_loop_closes_in_both_packages():
    """The JAX package's e2e loop scene (tests/test_e2e_loop.py) through both
    SlamSystems with default LoopClosingConfig: the same bars for each."""
    from sqrtlm_slam_tpu.eval.ate import ate_rmse
    from sqrtlm_slam_tpu.pipeline.system import SlamSystem, SystemConfig
    from sqrtlm_slam_tpu_torch.pipeline import system as t_system

    world = j_synth.ring_world(seed=7, n_points=2500)
    poses = j_synth.ring_trajectory(160, frac=1.3)
    frames = [tuple(np.asarray(a) for a in world.render(T, CAM_J)) for T in poses]
    cfg = SystemConfig(orb=j_orb.ORBConfig(max_features=600), loop_detection=True)
    systems = [SlamSystem(CAM_J, cfg, loop_cfg=j_closing.LoopClosingConfig()),
               t_system.SlamSystem(CAM, convert.system_config(cfg), device="cpu",
                                   loop_cfg=t_closing.LoopClosingConfig())]
    gt = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = np.asarray(T.R), np.asarray(T.t)
        gt.append(np.linalg.inv(M))
    for s in systems:
        tracked = sum(s.track_depth(img, depth) is not None for img, depth in frames)
        assert tracked >= len(poses) - 2
        assert s.loop_closer.num_loops_closed >= 1
        assert s.loop_closer.last_fused >= 20
        est = s.get_trajectory()
        rmse, _ = ate_rmse(est, np.stack(gt[: len(est)]))
        assert rmse < 0.3, rmse


def test_lazy_vocabulary_from_the_first_keyframe():
    """Without a vocabulary (use_shipped_vocab=False) the system trains one
    from the first keyframe's descriptors and hands it to the loop closer,
    as the JAX package does."""
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.pipeline import system as t_system
    from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig

    world = j_synth.ring_world(seed=7, n_points=2500)
    pose = j_synth.ring_trajectory(160, frac=1.3)[0]
    s = t_system.SlamSystem(CAM, t_system.SystemConfig(
        orb=ORBConfig(max_features=300), tracking=TrackingConfig(init_min_depth_kp=50),
        loop_detection=True, use_shipped_vocab=False), device="cpu")
    assert s.vocabulary is None
    img, depth = world.render(pose, CAM_J)
    assert s.track_depth(np.asarray(img), np.asarray(depth)) is not None
    assert s.vocabulary is not None and s.vocabulary.num_words == 1000
    assert s.loop_closer.voc is s.vocabulary
    valid = s.store.kf_kp_valid[0]
    assert (s.store.kf_words[0][valid] >= 0).all() and (s.store.kf_words[0][~valid] == -1).all()
    np.testing.assert_allclose(s.store.kf_bow[0].sum(), 1.0, rtol=1e-5)
