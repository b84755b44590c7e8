"""Port kernels K1 (Hamming) and K2 (BA assembly) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX package's Pallas kernels in interpret mode and its XLA
references. The CUDA kernels against their plain versions:
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.ops import hamming as jax_hamming
from sqrtlm_slam_tpu.optim import assembly_pallas, schur_bucketed
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.ops import hamming
from sqrtlm_slam_tpu_torch.optim import assembly
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_schur


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _full_words(rng, n):
    """(n, 8) uint32 words over the full 32-bit range (sign bit included)."""
    return rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


# ----------------------------------------------------------------------------
# K1 — Hamming matrix (exact: integer popcounts)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("Q,T", [(300, 450), (129, 1)])
def test_hamming_plain_matches_jax_reference_and_pallas(Q, T):
    rng = np.random.RandomState(Q)
    q, t = _full_words(rng, Q), _full_words(rng, T)
    assert (q >> 31).any(), "inputs must exercise the sign bit"
    ref = np.asarray(jax_hamming.hamming_matrix_reference(jnp.asarray(q), jnp.asarray(t)))
    pal = np.asarray(jax_hamming.hamming_matrix_pallas(jnp.asarray(q), jnp.asarray(t),
                                                        interpret=True))
    got = hamming.hamming_matrix(convert.desc_to_torch(q, "cpu"),
                                 convert.desc_to_torch(t, "cpu")).numpy()
    assert got.dtype == np.int32
    # Integer-exact: any difference is a bug.
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)


def test_hamming_identity_and_complement():
    rng = np.random.RandomState(1)
    d = _full_words(rng, 64)
    dt = convert.desc_to_torch(d, "cpu")
    D = hamming.hamming_matrix(dt, dt).numpy()
    assert (np.diagonal(D) == 0).all()
    comp = convert.desc_to_torch(~d, "cpu")
    assert (np.diagonal(hamming.hamming_matrix(dt, comp).numpy()) == 256).all()


def test_hamming_rejects_unknown_device_types():
    with pytest.raises(ValueError):
        hamming.hamming_matrix(torch.zeros((2, 8), dtype=torch.int32, device="meta"),
                               torch.zeros((2, 8), dtype=torch.int32, device="meta"))


# ----------------------------------------------------------------------------
# K2 — BA assembly
# ----------------------------------------------------------------------------

P, L, K = 8, 256, 4


def _problems(seed=0):
    flat, _ = make_ba_problem(seed=seed, P=P, L=L, stereo_frac=0.5, obs_per_landmark=K)
    prob = schur_bucketed.from_flat(flat, K)
    return prob, convert.ba_problem(prob)


def _port_assemble(tp, robust_delta):
    w_active = tp.obs_inv_sigma2 * tp.obs_valid.float()
    return assembly.assemble(tp.pose_R, tp.pose_t, ~tp.pose_fixed, tp.points, tp.obs_cam,
                             tp.obs_uvr, w_active, convert.camera(DEFAULT_CAM), robust_delta)


@pytest.mark.parametrize("robust_delta", [None, 2.447])
def test_assembly_plain_matches_pallas_interpret_and_xla(robust_delta):
    prob, tp = _problems(0)
    cam = DEFAULT_CAM
    w_active = prob.obs_inv_sigma2 * prob.obs_valid.astype(jnp.float32)
    with jax.disable_jit():
        pal = assembly_pallas.assemble.__wrapped__(
            prob.pose_R, prob.pose_t, ~prob.pose_fixed, prob.points, prob.obs_cam,
            prob.obs_uvr, w_active, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
            robust_delta=robust_delta, interpret=True,
        )
    terms = schur_bucketed._edge_terms(prob, cam, prob.obs_valid, robust_delta)[:5]
    xla = schur_bucketed.reductions_from_terms(prob, terms)
    got = _port_assemble(tp, robust_delta)
    for name, g, p, x in zip(assembly.AssemblyOut._fields, got, pal, xla):
        # The tolerance of tests/test_pallas_assembly.py: f32 reassociation of
        # cancellation-heavy sums (different summation orders).
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=5e-3, atol=5e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=5e-3, atol=5e-4, err_msg=name)


def test_assembly_masks_fixed_poses_and_inactive_slots():
    prob, tp = _problems(3)
    out = _port_assemble(tp, 2.447)
    fixed = tp.pose_fixed.numpy()
    assert fixed.any()
    assert np.abs(out.Hpp.numpy()[fixed]).max() == 0.0
    assert np.abs(out.bp.numpy()[fixed]).max() == 0.0
    # A fully inactive problem assembles to zero.
    idle = tp._replace(obs_valid=torch.zeros_like(tp.obs_valid))
    zero = _port_assemble(idle, 2.447)
    assert float(zero.chi2) == 0.0 and float(zero.Hll.abs().max()) == 0.0


def test_ba_iterate_matches_jax():
    """The port's LM loop vs the JAX XLA loop on the same problem: the
    accept/reject protocol is identical, but f32 reassociation can flip one
    marginal accept (gain ratio ~0), so accepted counts agree within 1 and
    chi2 within 5e-2 relative (the bar of tests/test_pallas_assembly.py)."""
    prob, tp = _problems(1)
    delta = 2.447
    out_j, chi2_j, acc_j = schur_bucketed.ba_iterate(prob, DEFAULT_CAM, prob.obs_valid, 8,
                                                      robust_delta=delta, use_pallas=False)
    out_t, chi2_t, acc_t = t_schur.ba_iterate(tp, convert.camera(DEFAULT_CAM), tp.obs_valid,
                                              8, robust_delta=delta)
    chi2_0 = float(schur_bucketed.chi2_only(prob, DEFAULT_CAM, prob.obs_valid, delta))
    assert abs(int(acc_j) - int(acc_t)) <= 1
    assert float(chi2_t) < 0.1 * chi2_0
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    np.testing.assert_allclose(out_t.pose_t.numpy(), np.asarray(out_j.pose_t),
                               rtol=5e-2, atol=5e-2)


def test_local_ba_matches_jax():
    """Two-phase local BA (robust, gate, plain) vs the JAX protocol."""
    prob, tp = _problems(2)
    out_j, surv_j, chi2_j = schur_bucketed.local_ba(prob, DEFAULT_CAM)
    out_t, surv_t, chi2_t = t_schur.local_ba(tp, convert.camera(DEFAULT_CAM))
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=5e-2)
    # Survivor gating compares chi2 against fixed gates; allow a handful of
    # slots at the gate to flip under f32 differences.
    assert (surv_t.numpy() != np.asarray(surv_j)).sum() <= 0.005 * surv_t.numel()
    np.testing.assert_allclose(out_t.points.numpy(), np.asarray(out_j.points),
                               rtol=5e-2, atol=5e-2)


def test_from_flat_matches_jax():
    flat, _ = make_ba_problem(seed=4, P=P, L=L, stereo_frac=0.5, obs_per_landmark=K)
    want = schur_bucketed.from_flat(flat, K)
    got = t_schur.from_flat(t_schur.BAProblem(*[np.asarray(x) for x in flat]), K)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_excess_over_plain_accepts_f32_plain_and_rejects_errors():
    """The K2-vs-plain rule used on the card: the float32 plain version
    passes it; a result off by more than the bound fails it."""
    _, tp = _problems(5)
    w = tp.obs_inv_sigma2 * tp.obs_valid.float()
    args = (tp.pose_R, tp.pose_t, (~tp.pose_fixed).float(), tp.points, tp.obs_cam,
            tp.obs_uvr, w, convert.camera(DEFAULT_CAM), 2.447)
    got = assembly.assemble_plain(*args)
    assert all(e <= 0 for e, _ in assembly.excess_over_plain(got, *args).values())
    for field in ("bl", "Hpp"):
        x = getattr(got, field).clone()
        x.view(-1)[7] += 1e-2 + 1e-2 * x.view(-1)[7].abs()
        bad = assembly.excess_over_plain(got._replace(**{field: x}), *args)
        assert bad[field][0] > 0
