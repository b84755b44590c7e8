"""Distributed BA in the port (`parallel/dist_ba.py`) against the JAX package
on a 4-device CPU mesh (tests/conftest.py provides 8 virtual devices), and
the port's shard counts against each other.

Gates: against JAX, those of tests/test_dist_ba.py (one step: pose_t atol
5e-4, points 5e-3; LM: accepted within 1, chi2 rtol 0.05, pose_t 5e-3,
points 2e-2). Between shard counts of the port (the same protocol, sums in
another order): accepted equal, chi2 rtol 1e-4, pose_t atol 1e-4, points
atol 1e-4 plus rtol 5e-5. Reruns in one process: bitwise equal.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sqrtlm_slam_tpu.optim import schur_bucketed as j_sb
from sqrtlm_slam_tpu.parallel import dist_ba as j_dist
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_sb
from sqrtlm_slam_tpu_torch.parallel import dist_ba as t_dist
from sqrtlm_slam_tpu_torch.parallel import multiprocess
from tests.test_schur_ba import CAM as J_CAM
from tests.test_schur_ba import make_ba_scene

KEY = jax.random.PRNGKey(77)
CAM = convert.camera(J_CAM)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:4]), axis_names=("ba",))


@pytest.fixture(scope="module")
def scenes():
    """The JAX tests' two scene shapes: (P=4, L=24) and (P=6, L=64), every
    pose seeing every landmark."""
    small = make_ba_scene(KEY, P=4, L=24, noise=0.4)[0]
    large = make_ba_scene(KEY, P=6, L=64, noise=0.4)[0]
    hard = make_ba_scene(KEY, P=6, L=64, noise=1.5)[0]
    return small, large, hard


def _bucketed(flat, K):
    b = j_sb.from_flat(flat, K=K)
    return b, convert.ba_problem(b)


def _mesh(n):
    return t_dist.make_mesh(n, "cpu")


def test_partitioners_equal_jax(scenes):
    """Both host partitioners give the JAX package's layout exactly, at
    shard counts that divide L and that do not."""
    small, large, _ = scenes
    for flat, K in ((small, 4), (large, 6)):
        b, tb = _bucketed(flat, K)
        tf = convert.flat_ba_problem(flat)
        for n in (1, 3, 4, 8):
            for j_fn, t_fn, j_in, t_in in ((j_dist.partition_problem, t_dist.partition_problem,
                                            flat, tf),
                                           (j_dist.partition_bucketed, t_dist.partition_bucketed,
                                            b, tb)):
                want, ids_j = j_fn(j_in, n)
                got, ids_t = t_fn(t_in, n)
                np.testing.assert_array_equal(ids_t, ids_j)
                want = (convert.sharded_ba_problem if j_fn is j_dist.partition_problem
                        else convert.sharded_bucketed)(want)
                assert type(want) is type(got)
                for name, w, g in zip(want._fields, want, got):
                    assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
                    np.testing.assert_array_equal(g, w, err_msg=f"{t_fn.__name__} {n} {name}")


def test_shard_pieces_and_step_match_jax(scenes):
    """What each shard computes (`build_local_pieces`: S_half, bp, rhs_corr,
    chi2; rtol 1e-4 with atol 1e-4 of each output's scale) and one bucketed
    step (`reduce_and_solve`: tests/test_dist_ba.py's step gates) against
    the JAX functions; `pieces_from_terms` gives `build_local_pieces`'s
    pieces from the plain edge terms."""
    b, tb = _bucketed(scenes[1], 6)
    mu = 1e-3
    for delta in (None, 2.447):
        want = j_sb.build_local_pieces(b, J_CAM, b.obs_valid, delta, mu)
        got = t_sb.build_local_pieces(tb, CAM, tb.obs_valid, delta, torch.tensor(mu))
        for name in ("S_half", "bp", "rhs_corr", "chi2", "bl"):
            w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        terms = t_sb._edge_terms(tb, CAM, tb.obs_valid, delta)[:5]
        again = t_sb.pieces_from_terms(tb, terms, torch.tensor(mu))
        for g, a in zip(got, again):
            assert torch.equal(g, a)
        want = j_sb.reduce_and_solve(b, J_CAM, b.obs_valid, delta, mu)
        got = t_sb.reduce_and_solve(tb, CAM, tb.obs_valid, delta, torch.tensor(mu))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=5e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=5e-3)
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


def test_flat_step_matches_jax(scenes, jax_mesh):
    flat = scenes[0]
    want, _ = j_dist.distributed_ba(flat, J_CAM, jax_mesh, num_iters=1, mu=1e-3)
    got, _ = t_dist.distributed_ba(convert.flat_ba_problem(flat), CAM, _mesh(4), num_iters=1,
                                   mu=1e-3)
    np.testing.assert_allclose(got.pose_t.numpy(), np.asarray(want.pose_t), atol=5e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=5e-3)


def test_bucketed_step_matches_jax(scenes, jax_mesh):
    b, tb = _bucketed(scenes[0], 4)
    want, chi2_j = j_dist.distributed_ba_bucketed(b, J_CAM, jax_mesh, num_iters=1, mu=1e-3)
    got, chi2_t = t_dist.distributed_ba_bucketed(tb, CAM, _mesh(4), num_iters=1, mu=1e-3)
    np.testing.assert_allclose(got.pose_t.numpy(), np.asarray(want.pose_t), atol=5e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=5e-3)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=1e-4)


def test_lm_matches_jax(scenes, jax_mesh):
    """6 Nielsen LM iterations over 4 shards against the JAX loop over a
    4-device mesh."""
    b, tb = _bucketed(scenes[1], 6)
    want, chi2_j, acc_j = j_dist.distributed_ba_lm(b, J_CAM, jax_mesh, num_iters=6)
    got, chi2_t, acc_t = t_dist.distributed_ba_lm(tb, CAM, _mesh(4), num_iters=6)
    assert abs(int(acc_t) - int(acc_j)) <= 1
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=0.05)
    np.testing.assert_allclose(got.pose_t.numpy(), np.asarray(want.pose_t), atol=5e-3)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=2e-2)


def test_shard_counts_agree_and_one_shard_is_the_single_device_loop(scenes):
    """D = 1, 2, 4 shards of the same LM protocol agree (sums in another
    order); D = 1 is the single-device bucketed LM loop, bitwise."""
    _, tb = _bucketed(scenes[1], 6)
    res = {D: t_dist.distributed_ba_lm(tb, CAM, _mesh(D), num_iters=6) for D in (1, 2, 4)}
    ref, chi2_ref, acc_ref = t_sb.ba_iterate(tb, CAM, tb.obs_valid, 6, robust_delta=None)
    assert torch.equal(res[1][0].points, ref.points) and torch.equal(res[1][1], chi2_ref)
    assert torch.equal(res[1][0].pose_t, ref.pose_t) and int(res[1][2]) == int(acc_ref)
    for D in (2, 4):
        out, chi2, acc = res[D]
        assert int(acc) == int(res[1][2])
        np.testing.assert_allclose(float(chi2), float(res[1][1]), rtol=1e-4)
        np.testing.assert_allclose(out.pose_t.numpy(), res[1][0].pose_t.numpy(), atol=1e-4)
        np.testing.assert_allclose(out.points.numpy(), res[1][0].points.numpy(), atol=1e-4,
                                   rtol=5e-5)


def test_rejects_then_recovers(scenes, jax_mesh):
    """Large noise: the loop rejects steps (fewer accepted than iterations)
    yet lowers chi2, as the JAX loop does on the same problem."""
    b, tb = _bucketed(scenes[2], 6)
    chi0 = float(t_sb.chi2_only(tb, CAM, tb.obs_valid, None))
    out, chi2, acc = t_dist.distributed_ba_lm(tb, CAM, _mesh(4), num_iters=10)
    _, chi2_j, acc_j = j_dist.distributed_ba_lm(b, J_CAM, jax_mesh, num_iters=10)
    assert float(chi2) <= chi0
    assert 0 < int(acc) < 10
    assert abs(int(acc) - int(acc_j)) <= 1
    np.testing.assert_allclose(float(chi2), float(chi2_j), rtol=0.05)


def test_reruns_are_bitwise_equal(scenes):
    _, tb = _bucketed(scenes[1], 6)
    a = t_dist.distributed_ba_lm(tb, CAM, _mesh(4), num_iters=4, robust_delta=2.447)
    b = t_dist.distributed_ba_lm(tb, CAM, _mesh(4), num_iters=4, robust_delta=2.447)
    for x, y in ((a[0].pose_R, b[0].pose_R), (a[0].pose_t, b[0].pose_t),
                 (a[0].points, b[0].points), (a[1], b[1]), (a[2], b[2])):
        assert torch.equal(x, y)


def test_package_exports_match_jax():
    import sqrtlm_slam_tpu.parallel as j_parallel
    import sqrtlm_slam_tpu_torch.parallel as t_parallel

    assert t_parallel.__all__ == j_parallel.__all__
    for name in t_parallel.__all__:
        assert getattr(t_parallel, name) is not None


def test_mesh_layout():
    m = t_dist.Mesh(["cpu", "cpu"], process_index=1, num_processes=3)
    assert m.num_shards == 6 and m.first_shard == 2 and m.home == torch.device("cpu")
    assert _mesh(4).devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        t_dist.Mesh([])


def test_nccl_with_ranks_sharing_a_gpu_raises_and_names_gloo():
    """Two ranks under nccl on fewer GPUs than ranks: a ValueError naming
    backend="gloo", raised before any process group is formed."""
    with pytest.raises(ValueError, match='backend="gloo"'):
        multiprocess.initialize("localhost:1", num_processes=max(torch.cuda.device_count(), 1) + 1,
                                process_id=0, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match='backend="gloo"'):
        multiprocess.initialize("localhost:1", num_processes=1, process_id=0, backend="nccl",
                                device="cpu")
    assert not torch.distributed.is_initialized()
