"""K2 and K3 and their callers at more than 16 slots per landmark, against
the JAX package on the same numpy inputs.

The JAX package takes any number of slots per landmark (K); so does the
port. On the CPU the port's wrappers run their plain versions; the JAX
package runs its XLA path (the Pallas kernel is for the TPU only). The
problems come from the port's numpy generator `eval/synthetic.make_ba_problem`
and the numpy scale store (`eval/scale.make_scale_store`, identical in both
packages). The CUDA kernels at these K against their plain versions:
tests/test_torch_cuda.py.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import scale as j_scale
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM
from sqrtlm_slam_tpu.mapstore import checkpoint as j_checkpoint
from sqrtlm_slam_tpu.loop import closing as j_closing
from sqrtlm_slam_tpu.optim import facade as j_facade
from sqrtlm_slam_tpu.optim import schur as j_schur
from sqrtlm_slam_tpu.optim import schur_bucketed as j_sb
from sqrtlm_slam_tpu.pipeline import local_mapping as j_lmap
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import scale as t_scale
from sqrtlm_slam_tpu_torch.eval.synthetic import make_ba_problem
from sqrtlm_slam_tpu_torch.loop import closing as t_closing
from sqrtlm_slam_tpu_torch.mapstore import checkpoint as t_checkpoint
from sqrtlm_slam_tpu_torch.optim import assembly
from sqrtlm_slam_tpu_torch.optim import facade as t_facade
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_sb
from sqrtlm_slam_tpu_torch.parallel import dist_ba as t_dist
from sqrtlm_slam_tpu_torch.parallel import mp_worker
from sqrtlm_slam_tpu_torch.pipeline import local_mapping as t_lmap

CAM = convert.camera(DEFAULT_CAM)  # also the scale store's camera
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problems(seed, P, L, K):
    """One numpy problem bucketed by both packages: K slots per landmark
    (K = 0: the dense problem, every pose sees every landmark, K = P)."""
    flat, _ = make_ba_problem(seed=seed, P=P, L=L, stereo_frac=0.5, obs_per_landmark=K)
    K = K or P
    jp = j_sb.from_flat(j_schur.BAProblem(*[jnp.asarray(x) for x in flat]), K)
    return jp, t_sb.from_flat(flat, K, device="cpu")


def _seen_twice(tp) -> np.ndarray:
    """Landmarks observed from at least two distinct cameras. The generator
    clips a landmark's slots at the chain's last pose, so the landmarks at
    its end are seen from that camera alone and have no determined depth:
    they are compared by chi2 only."""
    cams = np.where(tp.obs_valid.numpy(), tp.obs_cam.numpy(), -1)
    first = cams.max(1, keepdims=True)
    return ((cams >= 0) & (cams != first)).any(1)


@pytest.mark.parametrize("robust_delta", [None, 2.447])
@pytest.mark.parametrize("P,L,K", [(20, 256, 20), (24, 128, 0)])
def test_k2_and_k3_plain_match_jax_xla_at_wide_k(P, L, K, robust_delta):
    """K2's plain version against the JAX package's `_edge_terms` +
    `reductions_from_terms`, rtol 5e-3 / atol 5e-4 (tests/test_pallas_assembly.py's
    tolerance: float32 sums of cancelling terms in other orders); K3's
    plain version against `chi2_only`, rtol 1e-5; K3's chi2 equal to K2's.
    A fifth of the slots of the first column inactive."""
    jp, tp = _problems(11, P, L, K)
    assert tp.obs_cam.shape[1] > 16
    valid = np.asarray(jp.obs_valid).copy()
    valid[::5, 0] = False
    jp = jp._replace(obs_valid=jnp.asarray(valid))
    tp = tp._replace(obs_valid=torch.as_tensor(valid))
    terms = j_sb._edge_terms(jp, DEFAULT_CAM, jp.obs_valid, robust_delta)[:5]
    want = j_sb.reductions_from_terms(jp, terms)
    w = tp.obs_inv_sigma2 * tp.obs_valid.float()
    got = assembly.assemble(tp.pose_R, tp.pose_t, ~tp.pose_fixed, tp.points, tp.obs_cam,
                            tp.obs_uvr, w, CAM, robust_delta)
    for name, g, x in zip(assembly.AssemblyOut._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=5e-3, atol=5e-4, err_msg=name)
    chi2 = assembly.chi2_sum(tp.pose_R, tp.pose_t, tp.points, tp.obs_cam, tp.obs_uvr, w, CAM,
                             robust_delta)
    want_chi2 = float(j_sb.chi2_only(jp, DEFAULT_CAM, jp.obs_valid, robust_delta))
    np.testing.assert_allclose(float(chi2), want_chi2, rtol=1e-5)
    assert float(chi2) == float(got.chi2)


@pytest.mark.parametrize("backend", ["bucketed", "flat", "cg"])
def test_facade_backends_at_wide_k_match_jax(backend):
    """Two-phase local BA through each backend of both facades at K = 20:
    chi2 rtol 5e-2, survivors within 0.5%, landmarks seen from two cameras
    or more rtol / atol 5e-2 (the gates of tests/test_torch_kernels.py's
    local-BA test)."""
    jp, tp = _problems(12, 40, 256, 20)
    seen = _seen_twice(tp)
    out_j, surv_j, chi2_j = jax.jit(
        lambda p: j_facade.Optimizer(backend).local_bundle_adjustment(p, DEFAULT_CAM))(jp)
    out_t, surv_t, chi2_t = t_facade.Optimizer(backend).local_bundle_adjustment(tp, CAM)
    assert tuple(surv_t.shape) == (256, 20)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    assert (surv_t.numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_t.numel()
    np.testing.assert_allclose(out_t.points.numpy()[seen], np.asarray(out_j.points)[seen],
                               rtol=5e-2, atol=5e-2)


def test_distributed_lm_at_wide_k():
    """The distributed LM at K = 24 (`mp_worker --obs-per-lm 24`'s shape
    family): one shard is the single-device LM loop bitwise, two and four
    shards agree with it: accepted equal, chi2 rtol 1e-4, pose_t atol 1e-4
    (tests/test_torch_dist_ba.py's shard-count gates), landmarks seen from
    two cameras or more atol 1e-3 (the shard sums are added in another
    float32 order, and a landmark 15-20 m out seen over a baseline of a few
    poses moves by up to 5e-4 m under it)."""
    _, tp = _problems(13, 48, 192, 24)
    seen = _seen_twice(tp)
    mesh = lambda D: t_dist.make_mesh(D, "cpu")
    res = {D: t_dist.distributed_ba_lm(tp, CAM, mesh(D), num_iters=6) for D in (1, 2, 4)}
    ref, chi2_ref, acc_ref = t_sb.ba_iterate(tp, CAM, tp.obs_valid, 6, robust_delta=None)
    assert torch.equal(res[1][0].points, ref.points) and torch.equal(res[1][1], chi2_ref)
    assert int(res[1][2]) == int(acc_ref) > 0
    for D in (2, 4):
        out, chi2, acc = res[D]
        assert int(acc) == int(acc_ref)
        np.testing.assert_allclose(float(chi2), float(chi2_ref), rtol=1e-4)
        np.testing.assert_allclose(out.pose_t.numpy(), ref.pose_t.numpy(), atol=1e-4)
        np.testing.assert_allclose(out.points.numpy()[seen], ref.points.numpy()[seen],
                                   atol=1e-3)


def test_mp_worker_with_24_slots_per_landmark_equals_in_process(tmp_path):
    """`python -m sqrtlm_slam_tpu_torch.parallel.mp_worker --obs-per-lm 24`,
    one rank of two shards over gloo, against the in-process distributed LM
    over two shards on the same problem: bitwise equal (a one-rank
    all-reduce adds nothing; both run on two CPU threads)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    shape = dict(poses=32, landmarks=256, obs_per_lm=24, iters=4, seed=3)
    cmd = [sys.executable, "-m", "sqrtlm_slam_tpu_torch.parallel.mp_worker",
           "--coordinator", f"localhost:{port}", "--nproc", "1", "--pid", "0",
           "--shards-per-proc", "2", "--device", "cpu"]
    cmd += [a for k, v in shape.items() for a in (f"--{k.replace('_', '-')}", str(v))]
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    flat, _ = make_ba_problem(seed=3, P=32, L=256, obs_per_landmark=24)
    b = t_sb.from_flat(flat, 24, device="cpu")
    out, chi2, acc = t_dist.distributed_ba_lm(b, CAM, t_dist.make_mesh(2, "cpu"), num_iters=4)
    assert got["shards"] == 2 and got["accepted"] == int(acc) > 0
    assert got["digest"] == mp_worker.result_digest(out.pose_R.numpy(), out.pose_t.numpy(),
                                                    out.points.numpy(), chi2.numpy())


def _scale_stores(n_kf, n_lm, obs_per_lm):
    kw = dict(n_kf=n_kf, n_lm=n_lm, obs_per_lm=obs_per_lm, drift=4e-4)
    return j_scale.make_scale_store(**kw)[0], t_scale.make_scale_store(**kw)[0]


def test_local_ba_with_obs_cap_24_matches_jax():
    """Local BA through both packages' `LocalMapper` with
    `LocalMappingConfig(obs_cap=24)` on the scale store's map (every
    landmark seen by 26 keyframes, so the gather cuts each to 24 slots):
    the gathered problems are equal, and after `local_ba` the keyframe poses
    agree within 5e-3 m and the landmarks within 5e-2 (the LM gates of
    tests/test_torch_kernels.py), the same observations erased."""
    js, ts = _scale_stores(32, 400, 26)
    kw = dict(obs_cap=24, point_cap=512, local_kf_cap=8, pose_cap=32)
    jm = j_lmap.LocalMapper(js, DEFAULT_CAM, j_lmap.LocalMappingConfig(**kw))
    tm = t_lmap.LocalMapper(ts, CAM, t_lmap.LocalMappingConfig(**kw), device="cpu")
    center = 12
    (jprob, jmeta), (tprob, tmeta) = jm.gather_problem(center), tm.gather_problem(center)
    assert tprob.obs_cam.shape == (512, 24) and int(tprob.obs_valid.sum(1).max()) == 24
    for name in tprob._fields:
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
    for a, b in zip(tmeta[:4], jmeta[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    before = ts.lm_n_obs.copy()
    jm.local_ba(center)
    tm.local_ba(center)
    assert not np.array_equal(ts.kf_t, t_scale.make_scale_store(
        n_kf=32, n_lm=400, obs_per_lm=26, drift=4e-4)[0].kf_t)
    np.testing.assert_allclose(ts.kf_R, js.kf_R, atol=5e-3)
    np.testing.assert_allclose(ts.kf_t, js.kf_t, atol=5e-3)
    np.testing.assert_allclose(ts.lm_pos, js.lm_pos, rtol=5e-2, atol=5e-2)
    np.testing.assert_array_equal(ts.lm_n_obs, js.lm_n_obs)
    assert (ts.lm_n_obs <= before).all()


def test_obs_cap_past_the_stores_slots_leaves_them_inactive():
    """`obs_cap=24` on a store of `obs_per_landmark=7` (as `SlamSystem`'s
    store holds 16): the JAX package's gather raises there (a numpy
    broadcast error); the port's fills the store's 7 slots and leaves the
    other 17 inactive. Its gather equals the JAX gather at `obs_cap=7` in
    those 7 slots; the inactive slots are inert: in float64, local BA on the
    24-slot problem and on its first 7 slots lands on the same poses and
    landmarks (1e-8) with the same survivors; and the mapper's write-back
    runs at 24 slots."""
    js, ts = _scale_stores(32, 400, 5)
    assert ts.obs_per_landmark == 7
    kw = dict(point_cap=512, local_kf_cap=8, pose_cap=32)
    jm = j_lmap.LocalMapper(js, DEFAULT_CAM, j_lmap.LocalMappingConfig(obs_cap=7, **kw))
    tm = t_lmap.LocalMapper(ts, CAM, t_lmap.LocalMappingConfig(obs_cap=24, **kw), device="cpu")
    with pytest.raises(ValueError):
        j_lmap.LocalMapper(js, DEFAULT_CAM, j_lmap.LocalMappingConfig(obs_cap=24, **kw)
                           ).gather_problem(12)
    (jprob, jmeta), (tprob, tmeta) = jm.gather_problem(12), tm.gather_problem(12)
    assert tprob.obs_cam.shape == (512, 24) and not tprob.obs_valid[:, 7:].any()
    for name in ("obs_cam", "obs_uvr", "obs_inv_sigma2", "obs_valid"):
        np.testing.assert_array_equal(getattr(tprob, name)[:, :7].numpy(),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
    for a, b in zip(tmeta[2:4], jmeta[2:4]):
        np.testing.assert_array_equal(np.asarray(a)[:, :7], np.asarray(b))
        assert (np.asarray(a)[:, 7:] == -1).all()
    wide = tprob._replace(**{k: v.double() for k, v in tprob._asdict().items()
                             if v.is_floating_point()})
    narrow = wide._replace(**{k: getattr(wide, k)[:, :7].contiguous() for k in (
        "obs_cam", "obs_uvr", "obs_inv_sigma2", "obs_valid")})
    ow, sw, cw = t_sb.local_ba(wide, CAM)
    on, sn, cn = t_sb.local_ba(narrow, CAM)
    np.testing.assert_allclose(float(cw), float(cn), rtol=1e-10)
    np.testing.assert_allclose(ow.pose_t.numpy(), on.pose_t.numpy(), atol=1e-8)
    np.testing.assert_allclose(ow.points.numpy(), on.points.numpy(), atol=1e-8)
    assert torch.equal(sw[:, :7], sn) and not sw[:, 7:].any()
    before = ts.lm_n_obs.copy()
    tm.local_ba(12)
    assert (ts.lm_n_obs <= before).all() and np.isfinite(ts.kf_t).all()


def _pcg_without_overflow(matvec, b, Minv_blocks, pose_fixed, max_iters: int, tol: float):
    """The JAX package's `schur_bucketed._pcg` with the port's repair of its
    stop test: where the float32 squares of the residual or of the
    right-hand side overflow (`inf > inf` reads done before the first
    iteration), the test compares them scaled by the largest |b|, as the
    port compares them in float64 (`schur_bucketed._converged`)."""
    b = jnp.where(pose_fixed[:, None], 0.0, b)
    precond = lambda r: jnp.einsum("pij,pj->pi", Minv_blocks, r)  # noqa: E731
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    rz0 = jnp.sum(r0 * z0)
    b2 = jnp.maximum(jnp.sum(b * b), 1e-20)
    s = jnp.maximum(jnp.max(jnp.abs(b)), 1e-30)
    b2_s = jnp.sum((b / s) ** 2)

    def cond(state):
        _, r, _, _, k = state
        rr = jnp.sum(r * r)
        plain = rr > tol * tol * b2
        scaled = jnp.sum((r / s) ** 2) > tol * tol * b2_s
        return (k < max_iters) & jnp.where(jnp.isfinite(rr) & jnp.isfinite(b2), plain, scaled)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        return (x, r, z + beta * p, rz_new, k + 1)

    x, _, _, _, n = jax.lax.while_loop(cond, body, (x0, r0, z0, rz0, 0))
    return x, n


def test_global_ba_cg_after_checkpoint_round_trip_matches_jax(tmp_path, monkeypatch):
    """`global_ba_cg` on the whole-map problem of a store with
    `obs_per_landmark=32`, each package after its own `checkpoint` save and
    load: the loaded stores keep K = 32, the problems gathered from them are
    equal, and 10 GBA iterations agree (chi2 rtol 5e-2, survivors within
    0.5%, landmarks rtol / atol 5e-2: the gates of tests/test_torch_gba.py).
    This store's right-hand sides overflow the float32 squares of the
    PCG's stop test: the JAX package's reads done before the first
    iteration, the port's does not (a repaired fault), so the JAX package
    runs with the same repair (`_pcg_without_overflow`)."""
    monkeypatch.setattr(j_sb, "_pcg", _pcg_without_overflow)
    js, ts = _scale_stores(40, 300, 30)
    assert ts.obs_per_landmark == js.obs_per_landmark == 32
    j_checkpoint.save_map(js, str(tmp_path / "jax.npz"))
    t_checkpoint.save_map(ts, str(tmp_path / "port.npz"))
    js, _ = j_checkpoint.load_map(str(tmp_path / "jax.npz"))
    ts, _ = t_checkpoint.load_map(str(tmp_path / "port.npz"), device="cpu")
    assert ts.obs_per_landmark == js.obs_per_landmark == 32
    pj, _ = j_closing.gather_global_problem_bucketed(js)
    pt, _ = t_closing.gather_global_problem_bucketed(ts, device="cpu")
    L = pt.num_points  # the JAX gather pads L to 128 lanes; the port does not
    assert pt.obs_cam.shape == (L, 32)
    for name in pt._fields:
        want = np.asarray(getattr(pj, name))
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      want[:L] if want.shape[0] == pj.num_points else want,
                                      err_msg=name)
    out_j, surv_j, chi2_j = j_sb.global_ba_cg(pj, DEFAULT_CAM, num_iters=10)
    out_t, surv_t, chi2_t = t_sb.global_ba_cg(pt, CAM, num_iters=10)
    chi2_0 = float(t_sb.chi2_only(pt, CAM, pt.obs_valid, None))
    assert float(chi2_t) < chi2_0
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    surv_j = np.asarray(surv_j)[:L]
    assert (surv_t.numpy() != surv_j).sum() <= 0.005 * surv_t.numel()
    np.testing.assert_allclose(out_t.points.numpy(), np.asarray(out_j.points)[:L],
                               rtol=5e-2, atol=5e-2)
