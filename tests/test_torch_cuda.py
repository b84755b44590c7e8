"""Hand-written CUDA kernels K1, K2 and K3 against their plain PyTorch versions.

Marked `cuda`: each test skips where no CUDA device exists (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without JAX, skipping tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu_torch.loop import closing
from sqrtlm_slam_tpu_torch.ops import hamming
from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed
from sqrtlm_slam_tpu_torch.utils import desc_to_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _full_words(rng, n):
    """(n, 8) uint32 words over the full 32-bit range (sign bit included)."""
    return rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("Q,T", [(2048, 2000), (4096, 2000), (2000, 2000), (37, 5)])
def test_hamming_kernel_matches_plain_on_card(cuda_device, Q, T):
    rng = np.random.RandomState(Q + T)
    q = desc_to_torch(_full_words(rng, Q), cuda_device)
    t = desc_to_torch(_full_words(rng, T), cuda_device)
    before = hamming.launch_count
    got = hamming.hamming_matrix(q, t)
    torch.cuda.synchronize()
    assert hamming.launch_count == before + 1
    # Integer-exact.
    assert torch.equal(got, hamming.hamming_matrix_plain(q, t))


def test_hamming_kernel_rejects_bad_inputs(cuda_device):
    good = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        hamming.hamming_matrix(good.to(torch.int64), good)
    with pytest.raises(ValueError):
        hamming.hamming_matrix(good[:, :4], good)
    with pytest.raises(ValueError):
        hamming.hamming_matrix(good.t().contiguous().t(), good)


@pytest.mark.parametrize("robust_delta", [None, 2.447])
@pytest.mark.parametrize("P,L,K", [(32, 4096, 8), (96, 8192, 5), (8, 300, 4)])
def test_assembly_kernel_matches_plain_on_card(cuda_device, robust_delta, P, L, K):
    flat, _ = make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6, obs_per_landmark=K)
    prob = schur_bucketed.from_flat(flat, K, device=cuda_device)
    w = prob.obs_inv_sigma2 * prob.obs_valid.float()
    args = (prob.pose_R, prob.pose_t, (~prob.pose_fixed).float(), prob.points, prob.obs_cam,
            prob.obs_uvr, w, DEFAULT_CAM, robust_delta)
    before = assembly.launch_count
    got = assembly.assemble(*args)
    again = assembly.assemble(*args)
    torch.cuda.synchronize()
    assert assembly.launch_count == before + 2
    for name, g, a in zip(assembly.AssemblyOut._fields, got, again):
        assert torch.equal(g, a), f"{name}: kernel is not run-to-run repeatable"
    # rtol 5e-3 / atol 5e-4 against the plain version in float64, with the
    # float32 summation bound for near-cancelling landmark sums (see
    # assembly.excess_over_plain: no float32 evaluation meets 5e-4 there).
    excess = assembly.excess_over_plain(got, *args)
    assert all(e <= 0 for e, _ in excess.values()), excess


def test_ba_iterate_on_card_tracks_cpu(cuda_device):
    """The LM loop with K2 on the card against the same loop on the CPU (plain
    reductions): accepted counts within 1, chi2 within 5e-2 relative."""
    flat, _ = make_ba_problem(seed=1, P=16, L=1024, stereo_frac=0.6, obs_per_landmark=4)
    results = []
    for dev in ("cpu", cuda_device):
        prob = schur_bucketed.from_flat(flat, 4, device=dev)
        out, chi2, acc = schur_bucketed.ba_iterate(prob, DEFAULT_CAM, prob.obs_valid, 8,
                                                   robust_delta=2.447)
        results.append((float(chi2), int(acc), out.pose_t.cpu().numpy()))
    (c0, a0, t0), (c1, a1, t1) = results
    assert abs(a0 - a1) <= 1
    np.testing.assert_allclose(c1, c0, rtol=5e-2)
    np.testing.assert_allclose(t1, t0, rtol=5e-2, atol=5e-2)


def _k3_problem(shape, device):
    """The bench-shape problem, a small one, or the global-BA-at-scale
    problem (600 keyframes, 1.2e5 landmarks, 7 slots)."""
    if shape == "scale":
        store, _, _ = make_scale_store(n_kf=600, n_lm=120_000, obs_per_lm=5, drift=4e-4)
        return closing.gather_global_problem_bucketed(store, device)[0]
    P, L, K = shape
    flat, _ = make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6, obs_per_landmark=K)
    return schur_bucketed.from_flat(flat, K, device=device)


@pytest.mark.parametrize("robust_delta", [None, 2.447])
@pytest.mark.parametrize("shape", [(96, 8192, 5), (8, 300, 4), "scale"])
def test_chi2_kernel_matches_plain_on_card(cuda_device, robust_delta, shape):
    """K3 within rtol 1e-4 of its plain version evaluated in float64,
    bitwise repeatable, and bitwise equal to K2's chi2 on the same inputs
    (same projection, loss and summation order)."""
    prob = _k3_problem(shape, cuda_device)
    w = prob.obs_inv_sigma2 * prob.obs_valid.float()
    w[::5, 0] = 0.0  # inactive slots
    args = (prob.pose_R, prob.pose_t, prob.points, prob.obs_cam, prob.obs_uvr, w,
            DEFAULT_CAM, robust_delta)
    before = assembly.chi2_launch_count
    got = assembly.chi2_sum(*args)
    again = assembly.chi2_sum(*args)
    torch.cuda.synchronize()
    assert assembly.chi2_launch_count == before + 2
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, again)
    args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    want = float(assembly.chi2_plain(*args64))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    k2 = assembly.assemble(prob.pose_R, prob.pose_t, (~prob.pose_fixed).float(), prob.points,
                           prob.obs_cam, prob.obs_uvr, w, DEFAULT_CAM, robust_delta)
    assert torch.equal(got, k2.chi2)


def test_chi2_kernel_rejects_bad_inputs(cuda_device):
    flat, _ = make_ba_problem(seed=0, P=4, L=64, obs_per_landmark=3)
    prob = schur_bucketed.from_flat(flat, 3, device=cuda_device)
    w = prob.obs_inv_sigma2
    with pytest.raises(TypeError):
        assembly.chi2_cuda(prob.pose_R.double(), prob.pose_t, prob.points, prob.obs_cam,
                           prob.obs_uvr, w, DEFAULT_CAM, None)
    with pytest.raises(ValueError):
        assembly.chi2_cuda(prob.pose_R, prob.pose_t, prob.points[:10], prob.obs_cam,
                           prob.obs_uvr, w, DEFAULT_CAM, None)
    with pytest.raises(ValueError):
        assembly.chi2_cuda(prob.pose_R.cpu(), prob.pose_t, prob.points, prob.obs_cam,
                           prob.obs_uvr, w, DEFAULT_CAM, None)


def test_global_ba_on_card_is_repeatable_and_tracks_cpu(cuda_device):
    """Global BA through the loop closer on a 400-keyframe store: two runs on
    the card give bitwise-equal poses and landmarks (fixed-order camera sums),
    and the result agrees with the same run on the CPU within 1e-3 absolute
    plus 1e-4 relative (float32 world coordinates up to ~80 m, reductions
    summed in another order on the card than on the CPU)."""
    results = []
    for dev in (cuda_device, cuda_device, "cpu"):
        store, _, _ = make_scale_store(n_kf=400, n_lm=8000, obs_per_lm=5, drift=4e-4)
        lc = closing.LoopCloser(store, DEFAULT_CAM, cfg=closing.LoopClosingConfig(
            gba_iters=6, gba_chunk=3), device=dev)
        k2, k3 = assembly.launch_count, assembly.chi2_launch_count
        assert lc.run_global_ba() is True
        if dev != "cpu":
            assert assembly.launch_count > k2 and assembly.chi2_launch_count > k3
        results.append((store.kf_R.copy(), store.kf_t.copy(), store.lm_pos.copy()))
    for a, b in zip(results[0], results[1]):
        np.testing.assert_array_equal(a, b)
    for a, c in zip(results[0], results[2]):
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-3)
