"""Distributed BA's two execution forms in the port (`parallel/dist_ba.py`)
on the CPU, where every graphed name runs its eager function:

  * in one process the whole-program form (`_lm_loop_jit`,
    `_bucketed_step_jit`, `_flat_step_jit`: one graph each on the card) and
    the segmented form (`_lm_segmented`, `_bucketed_step_segmented`,
    `_flat_step_segmented`: the per-device segment graphs with the sums
    between them, as across processes) give the same bits over 1, 2 and 4
    shards;
  * the segmented LM over 4 shards matches the JAX package's
    `make_bucketed_lm_iterate` on a 4-device CPU mesh (tests/conftest.py
    provides 8 virtual devices) at tests/test_torch_dist_ba.py's LM gates
    (accepted within 1, chi2 rtol 0.05, pose_t atol 5e-3, points 2e-2);
  * the segmented LM over one shard is the single-device bucketed LM loop
    bit for bit;
  * the mesh alone chooses the form; the flat engine's edge plans are
    built once per `distributed_ba` call, not once a step.

The same graphs on the card: tests/test_torch_graphs_cuda.py.
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
from tests.test_schur_ba import CAM as J_CAM
from tests.test_schur_ba import make_ba_scene

KEY = jax.random.PRNGKey(77)
CAM = convert.camera(J_CAM)
DELTA = 2.447


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
    """tests/test_torch_dist_ba.py's (P=6, L=64) scenes, every pose seeing
    every landmark: noise 0.4 and 1.5 (the loop rejects steps)."""
    return {"large": make_ba_scene(KEY, P=6, L=64, noise=0.4)[0],
            "hard": make_ba_scene(KEY, P=6, L=64, noise=1.5)[0]}


def _bucketed(flat, K=6):
    b = j_sb.from_flat(flat, K=K)
    return b, convert.ba_problem(b)


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
        return torch.equal(a, b)
    return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))


def _sharded(tb, D):
    mesh = t_dist.make_mesh(D, "cpu")
    return mesh, t_dist.to_shards(t_dist.partition_bucketed(tb, D)[0], mesh)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_lm_whole_loop_and_segments_give_the_same_bits(scenes, D):
    """The whole loop (what `make_bucketed_lm_iterate` runs in one process)
    and the segmented form, robust and plain, 6 iterations."""
    _, tb = _bucketed(scenes["large"])
    mesh, sp = _sharded(tb, D)
    assert t_dist._one_graph(mesh)
    for delta in (DELTA, None):
        whole = t_dist._lm_loop_jit(sp, cam=CAM, num_iters=6, robust_delta=delta, mu0=1e-3)
        seg = t_dist._lm_segmented(mesh, sp, CAM, 6, delta, 1e-3)
        out, chi2, n_acc = t_dist.make_bucketed_lm_iterate(mesh, CAM, num_iters=6,
                                                           robust_delta=delta)(sp)
        assert _same_bits(tuple(whole), tuple(seg))
        assert _same_bits((out.pose_R, out.pose_t, out.points, chi2, n_acc),
                          (whole.pose_R, whole.pose_t, whole.points, whole.chi2, whole.n_acc))
        assert len(seg.points) == D and int(n_acc) > 0


@pytest.mark.parametrize("D", [1, 2, 4])
def test_steps_whole_and_segments_give_the_same_bits(scenes, D):
    """Two bucketed steps (robust) and two flat steps: one graph a step
    against the head and solve segments with the sum between them."""
    flat = scenes["large"]
    _, tb = _bucketed(flat)
    mesh, sp = _sharded(tb, D)
    step = t_dist.make_bucketed_ba_step(mesh, CAM, mu=1e-3, robust_delta=DELTA)
    a = b = sp
    for _ in range(2):
        a, chi2_a = step(a)
        b, chi2_b = t_dist._bucketed_step_segmented(mesh, b, CAM, 1e-3, DELTA)
        assert _same_bits((a.pose_R, a.pose_t, a.points, chi2_a),
                          (b.pose_R, b.pose_t, b.points, chi2_b))
    fp = t_dist.to_shards(t_dist.partition_problem(convert.flat_ba_problem(flat), D)[0], mesh)
    plans = t_dist.shard_edge_plans(fp)
    step = t_dist.make_distributed_ba_step(mesh, CAM, mu=1e-3)
    a = b = fp
    for _ in range(2):
        a, chi2_a = step(a, plans)
        b, chi2_b = t_dist._flat_step_segmented(mesh, b, plans, CAM, 1e-3, None)
        assert _same_bits((a.pose_R, a.pose_t, a.points, chi2_a),
                          (b.pose_R, b.pose_t, b.points, chi2_b))
    again, chi2_again = step(fp)  # plans built inside the step
    first, chi2_first = step(fp, plans)
    assert _same_bits((again.points, chi2_again), (first.points, chi2_first))


@pytest.mark.parametrize("scene", ["large", "hard"])
def test_segmented_lm_over_four_shards_matches_jax(scenes, jax_mesh, scene):
    """6 (large) or 10 (hard: rejections) iterations of the segmented form
    over 4 shards against the JAX loop over a 4-device mesh, shard by
    shard."""
    b, tb = _bucketed(scenes[scene])
    iters = 6 if scene == "large" else 10
    sharded, _ = j_dist.partition_bucketed(b, 4)
    want, chi2_j, acc_j = j_dist.make_bucketed_lm_iterate(jax_mesh, J_CAM,
                                                          num_iters=iters)(sharded)
    mesh, sp = _sharded(tb, 4)
    got = t_dist._lm_segmented(mesh, sp, CAM, iters, None, 1e-3)
    assert abs(int(got.n_acc) - int(acc_j)) <= 1
    np.testing.assert_allclose(float(got.chi2), float(chi2_j), rtol=0.05)
    np.testing.assert_allclose(got.pose_t.numpy(), np.asarray(want.pose_t), atol=5e-3)
    np.testing.assert_allclose(torch.stack(got.points).numpy(), np.asarray(want.points),
                               atol=2e-2)
    if scene == "hard":
        assert 0 < int(got.n_acc) < iters


def test_segmented_lm_over_one_shard_is_the_single_device_loop(scenes):
    _, tb = _bucketed(scenes["large"])
    mesh, sp = _sharded(tb, 1)
    got = t_dist._lm_segmented(mesh, sp, CAM, 6, None, 1e-3)
    ref, chi2_ref, acc_ref = t_sb.ba_iterate(tb, CAM, tb.obs_valid, 6, robust_delta=None)
    assert _same_bits((got.pose_R, got.pose_t, got.points[0], got.chi2),
                      (ref.pose_R, ref.pose_t, ref.points, chi2_ref))
    assert int(got.n_acc) == int(acc_ref)


def test_the_mesh_alone_chooses_the_form(scenes, monkeypatch):
    """One process with every shard on one device: the whole loop; several
    processes, or several devices in one process: the segments."""
    assert t_dist._one_graph(t_dist.make_mesh(4, "cpu"))
    assert not t_dist._one_graph(t_dist.Mesh(["cpu"] * 2, process_index=1, num_processes=2))
    assert not t_dist._one_graph(t_dist.Mesh(["cuda:0", "cuda:1", "cuda:0"]))
    _, tb = _bucketed(scenes["large"])
    mesh, sp = _sharded(tb, 2)
    called = []
    monkeypatch.setattr(t_dist, "_lm_segmented", lambda *a: called.append("segments"))
    monkeypatch.setattr(t_dist, "_lm_loop_jit", lambda *a, **k: called.append("whole"))
    for m in (mesh, t_dist.Mesh(mesh.devices, process_index=0, num_processes=2)):
        with pytest.raises(AttributeError):  # the stubs return no state
            t_dist.make_bucketed_lm_iterate(m, CAM, num_iters=2)(sp)
    assert called == ["whole", "segments"]


def test_flat_plans_are_built_once_per_call(scenes, monkeypatch):
    """`distributed_ba` builds each shard's edge plans once (three host
    reads a shard on the card), however many steps it takes."""
    built = []
    edge_plans = t_dist.schur.edge_plans

    def counted(*a, **k):
        built.append(1)
        return edge_plans(*a, **k)

    monkeypatch.setattr(t_dist.schur, "edge_plans", counted)
    out, chi2 = t_dist.distributed_ba(convert.flat_ba_problem(scenes["large"]), CAM,
                                      t_dist.make_mesh(4, "cpu"), num_iters=3, mu=1e-3)
    assert len(built) == 4 and np.isfinite(float(chi2))
