"""Hand-written CUDA kernels K1, K2 and K3 against their plain PyTorch versions,
and the LiDAR / RANSAC modules of the fusion and relocalisation paths on the
card against the CPU (same rules for ties and scatter winners on both).

Marked `cuda`: each test skips where no CUDA device exists (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without JAX, skipping tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu_torch.algorithm import pnp
from sqrtlm_slam_tpu_torch.eval import planeworld, synthetic
from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
from sqrtlm_slam_tpu_torch.lidar import features as lidar_features
from sqrtlm_slam_tpu_torch.lidar import voxel_map
from sqrtlm_slam_tpu_torch.loop import closing
from sqrtlm_slam_tpu_torch.loop.sim3_solver import minimal_sets
from sqrtlm_slam_tpu_torch.ops import hamming
from sqrtlm_slam_tpu_torch.optim import assembly, facade, schur_bucketed
from sqrtlm_slam_tpu_torch.parallel import dist_ba
from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
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


@pytest.mark.parametrize("Q,T", [(2048, 2000), (4096, 2000), (2000, 2000), (1, 1), (37, 5),
                                 (129, 2047), (2047, 129)])
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
@pytest.mark.parametrize("P,L,K", [(32, 4096, 8), (96, 8192, 5), (8, 300, 4), (24, 512, 16),
                                   (1000, 10000, 6), (1400, 60000, 7)])
def test_assembly_kernel_matches_plain_on_card(cuda_device, robust_delta, P, L, K):
    """K2 against its plain version, at the local-BA shapes and past the
    ~954 poses that bounded its first design (it has no pose cap now). The
    large problems keep the bench problem's 14.4 m track and drop
    observations nearer than 1 m to a camera."""
    big = dict(spacing=96 * 0.15 / P, min_depth=1.0) if P > 96 else {}
    flat, _ = make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6, obs_per_landmark=K, **big)
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
    # With hundreds of slots per camera (P > 96 here) Hpp and bp may also lie
    # within the float32 summation bound: there the float32 plain version
    # misses atol on cancelling off-diagonal entries too.
    excess = assembly.excess_over_plain(got, *args, camera_sums=P > 96)
    assert all(e <= 0 for e, _ in excess.values()), excess
    groups = schur_bucketed.camera_groups(prob, prob.obs_valid)
    with_groups = assembly.assemble(*args, groups=groups)
    for name, g, a in zip(assembly.AssemblyOut._fields, got, with_groups):
        assert torch.equal(g, a), f"{name}: differs with the caller's camera grouping"


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


def test_flat_local_ba_on_card_tracks_cpu(cuda_device):
    """The flat backend (plain PyTorch, fixed-order keyed sums) through the
    facade on the card against the CPU: chi2 within 5e-2 relative, poses
    within 5e-2, survivors within 0.5%; two runs on the card bitwise equal."""
    flat, _ = make_ba_problem(seed=2, P=16, L=1024, stereo_frac=0.6, obs_per_landmark=4)
    results = []
    for dev in ("cpu", cuda_device, cuda_device):
        prob = schur_bucketed.from_flat(flat, 4, device=dev)
        out, surv, chi2 = facade.Optimizer("flat").local_bundle_adjustment(prob, DEFAULT_CAM)
        results.append((float(chi2), out.pose_t.cpu().numpy(), out.points.cpu().numpy(),
                        surv.cpu().numpy()))
    (c0, t0, p0, s0), (c1, t1, p1, s1), (c2, t2, p2, s2) = results
    assert c1 == c2 and np.array_equal(t1, t2) and np.array_equal(p1, p2)
    np.testing.assert_allclose(c1, c0, rtol=5e-2)
    np.testing.assert_allclose(t1, t0, rtol=5e-2, atol=5e-2)
    assert (s0 != s1).sum() <= 0.005 * s0.size


def test_distributed_lm_on_card_four_shards_track_one(cuda_device):
    """Distributed LM with 1 and 4 shards on one card: K2 launches once per
    shard per iteration and K3 once per shard per chi2 evaluation; 4 shards
    against 1 within tests/test_dist_ba.py's LM gates (accepted within 1,
    chi2 rtol 5e-2, pose_t atol 5e-3, points 2e-2: the card's float32 sums
    in another order move far landmarks by ~2e-3); a rerun bitwise equal."""
    flat, _ = make_ba_problem(seed=0, P=24, L=2048, stereo_frac=0.6, obs_per_landmark=5)
    prob = schur_bucketed.from_flat(flat, 5, device=cuda_device)
    iters, res = 6, {}
    for D in (1, 4, 4):
        k2, k3 = assembly.launch_count, assembly.chi2_launch_count
        mesh = dist_ba.make_mesh(D, cuda_device)
        out, chi2, acc = dist_ba.distributed_ba_lm(prob, DEFAULT_CAM, mesh, num_iters=iters,
                                                   robust_delta=2.447)
        torch.cuda.synchronize()
        assert assembly.launch_count - k2 == D * iters
        assert assembly.chi2_launch_count - k3 == D * (iters + 1)
        res.setdefault(D, []).append((out, chi2, acc))
    (o1, c1, a1), = res[1]
    (o4, c4, a4), (o4b, c4b, a4b) = res[4]
    assert torch.equal(o4.points, o4b.points) and torch.equal(c4, c4b)
    assert abs(int(a4) - int(a1)) <= 1
    np.testing.assert_allclose(float(c4), float(c1), rtol=5e-2)
    np.testing.assert_allclose(o4.pose_t.cpu().numpy(), o1.pose_t.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(o4.points.cpu().numpy(), o1.points.cpu().numpy(), atol=2e-2)


def _k3_problem(shape, device):
    """The bench-shape problem, a small one, the global-BA-at-scale problem
    (600 keyframes, 1.2e5 landmarks, 7 slots), or one with KITTI 00's
    keyframe count or more on the bench problem's 14.4 m track
    (observations nearer than 1 m to a camera dropped)."""
    if shape == "scale":
        store, _, _ = make_scale_store(n_kf=600, n_lm=120_000, obs_per_lm=5, drift=4e-4)
        return closing.gather_global_problem_bucketed(store, device)[0]
    P, L, K = shape
    big = dict(spacing=96 * 0.15 / P, min_depth=1.0) if P > 96 else {}
    flat, _ = make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6, obs_per_landmark=K, **big)
    return schur_bucketed.from_flat(flat, K, device=device)


def _k3_args(prob, robust_delta):
    w = prob.obs_inv_sigma2 * prob.obs_valid.float()
    w[::5, 0] = 0.0  # inactive slots
    return (prob.pose_R, prob.pose_t, prob.points, prob.obs_cam, prob.obs_uvr, w,
            DEFAULT_CAM, robust_delta)


def _k2_chi2(prob, args):
    return assembly.assemble(prob.pose_R, prob.pose_t, (~prob.pose_fixed).float(), prob.points,
                             *args[3:]).chi2


@pytest.mark.parametrize("robust_delta", [None, 2.447])
@pytest.mark.parametrize("shape", [(96, 8192, 5), (8, 300, 4), "scale", (1400, 60000, 7),
                                   (6000, 60000, 7)])
def test_chi2_kernel_matches_plain_on_card(cuda_device, robust_delta, shape):
    """K3 within rtol 1e-4 of its plain version evaluated in float64,
    bitwise repeatable, and bitwise equal to K2's chi2 on the same inputs
    (same projection, loss and summation order). P=6000 lies past the
    ~4,460 poses that K3's first design staged in shared memory."""
    prob = _k3_problem(shape, cuda_device)
    args = _k3_args(prob, robust_delta)
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
    assert torch.equal(got, _k2_chi2(prob, args))


@pytest.mark.parametrize("L", [1, 127, 129, 1000, 8191])
def test_chi2_kernel_equals_k2_at_ragged_landmark_counts(cuda_device, L):
    """K2's chi2 and K3's are bitwise equal when L is not a multiple of the
    128-landmark tile (K3 copies a ragged last tile by its threads)."""
    prob = _k3_problem((24, L, 6), cuda_device)
    for delta in (None, 2.447):
        args = _k3_args(prob, delta)
        got = assembly.chi2_sum(*args)
        assert torch.equal(got, _k2_chi2(prob, args))
        args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                  for a in args]
        np.testing.assert_allclose(float(got), float(assembly.chi2_plain(*args64)), rtol=1e-4)


def test_chi2_kernel_on_two_streams_at_once(cuda_device):
    """K3 on two streams at once, on the same inputs and on different ones,
    gives the bits of a lone call: each stream has its own launch ticket and
    partials. Each stream runs several launches back to back, so the two
    streams' launches overlap on the card."""
    probs = [_k3_problem((96, 8192, 5), cuda_device), _k3_problem((600, 60000, 7), cuda_device)]
    args = [_k3_args(p, 2.447) for p in probs]
    alone = [assembly.chi2_sum(*a) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for pair in ((0, 0), (0, 1), (1, 0)):
        outs = [[], []]
        for _ in range(8):
            for s, (stream, which) in enumerate(zip(streams, pair)):
                with torch.cuda.stream(stream):
                    outs[s].append(assembly.chi2_sum(*args[which]))
        torch.cuda.synchronize()
        for s, which in enumerate(pair):
            for got in outs[s]:
                assert torch.equal(got, alone[which]), (pair, s)


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
    # More slots per landmark than the kernel's rho buffer holds (16).
    flat, _ = make_ba_problem(seed=0, P=20, L=64, obs_per_landmark=17)
    wide = schur_bucketed.from_flat(flat, 17, device=cuda_device)
    with pytest.raises(ValueError):
        assembly.chi2_cuda(wide.pose_R, wide.pose_t, wide.points, wide.obs_cam, wide.obs_uvr,
                           wide.obs_inv_sigma2, DEFAULT_CAM, None)



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


# ----------------------------------------------------------------------
# LiDAR features, voxel-hash NN and the RANSAC banks: card against CPU
# ----------------------------------------------------------------------


def _small_scan():
    """A noisy 32-ring x 720-ray scan of a small street, rays at the column
    centres of a 0.5-degree range image."""
    world = planeworld.street_circuit_world(seed=0, A=12.0, B=8.0, half_width=4.0, texel=0.05,
                                            panel_spacing=6.0)
    poses, _ = planeworld.circuit_trajectory(4, A=12.0, B=8.0, corner_r=3.0, step=0.5)
    raw = world.lidar_scan(poses[3], planeworld.T_CAM_VELO, n_rings=32, n_azimuth=720,
                           noise_seed=3)
    pts, _ = planeworld.center_scan_on_columns(raw, planeworld.T_CAM_VELO, 0.5)
    # Duplicated points: cells with several candidates at one range.
    pts = np.concatenate([pts, pts[::17], np.full((5, 3), np.nan, np.float32)])
    return pts, lidar_features.LidarConfig(num_rings=32, horizon_res_deg=0.5)


def test_extract_features_on_card_equals_cpu_and_repeats(cuda_device):
    """The same cells are picked on the card as on the CPU (points and masks
    exact: stable sorts, explicit scatter winners); normals to 1e-4 (the
    plane fit solves its normal equations in float64); two runs on the card
    are bitwise equal."""
    pts, cfg = _small_scan()
    f_cpu = lidar_features.extract_features(torch.as_tensor(pts), cfg)
    f_a = lidar_features.extract_features(torch.as_tensor(pts, device=cuda_device), cfg)
    f_b = lidar_features.extract_features(torch.as_tensor(pts, device=cuda_device), cfg)
    torch.cuda.synchronize()
    assert int(f_cpu.sharp_valid.sum()) > 5 and int(f_cpu.flat_valid.sum()) > 100
    for name, a, b in zip(f_a._fields, f_a, f_b):
        assert torch.equal(a, b), f"{name}: two runs on the card differ"
    for name in ("sharp", "less_sharp", "less_flat"):
        v = getattr(f_cpu, name + "_valid")
        assert torch.equal(getattr(f_a, name + "_valid").cpu(), v), name
        assert torch.equal(getattr(f_a, name).cpu()[v], getattr(f_cpu, name)[v]), name
    # Flat picks also depend on the plane fit's validity (a float threshold).
    v_cpu, v_gpu = f_cpu.flat_valid, f_a.flat_valid.cpu()
    assert int((v_cpu != v_gpu).sum()) <= 0.01 * int(v_cpu.sum())
    same = v_cpu & v_gpu & (f_a.flat.cpu() == f_cpu.flat).all(-1)
    assert int(same.sum()) >= 0.95 * int(v_cpu.sum())
    diff = (f_a.flat_normal.cpu()[same] - f_cpu.flat_normal[same]).abs().max(-1).values
    assert float(diff.max()) < 1e-4, float(diff.max())


def test_range_image_and_downsample_winners_on_card(cuda_device):
    """Scatters with repeated indices: the range image's cell point and the
    voxel representative are the same on the card as on the CPU (the range
    itself to 1e-6 relative: the card contracts x*x + y*y + z*z into FMAs)."""
    pts, cfg = _small_scan()
    img_cpu = lidar_features.build_range_image(torch.as_tensor(pts), cfg)
    img_gpu = lidar_features.build_range_image(torch.as_tensor(pts, device=cuda_device), cfg)
    np.testing.assert_allclose(img_gpu.depth.cpu().numpy(), img_cpu.depth.numpy(), rtol=1e-6)
    for name in ("xyz", "valid", "ground"):
        assert torch.equal(getattr(img_gpu, name).cpu(), getattr(img_cpu, name)), name
    good = torch.as_tensor(np.isfinite(pts).all(-1))
    for cap in (4096, 300):
        o_cpu, v_cpu = voxel_map.voxel_downsample(torch.as_tensor(pts), good, 0.4, cap)
        o_gpu, v_gpu = voxel_map.voxel_downsample(torch.as_tensor(pts, device=cuda_device),
                                                  good.to(cuda_device), 0.4, cap)
        assert torch.equal(v_gpu.cpu(), v_cpu) and torch.equal(o_gpu.cpu(), o_cpu)


@pytest.mark.parametrize("k", [1, 3])
def test_knn_on_card_equals_cpu(cuda_device, k):
    rng = np.random.RandomState(4)
    pts = (rng.randn(5000, 3) * [20.0, 20.0, 2.0]).astype(np.float32)
    pts[1000:1500] = pts[:500]  # equal distances: the lowest slot must win
    valid = rng.rand(5000) > 0.1
    queries = (pts[:800] + rng.randn(800, 3) * 0.1).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        vm = voxel_map.build(torch.as_tensor(pts, device=dev), torch.as_tensor(valid, device=dev),
                             0.8)
        out.append([x.cpu() for x in voxel_map.knn(vm, torch.as_tensor(queries, device=dev), k=k,
                                                   max_dist=0.45)])
    (i0, d0, ok0), (i1, d1, ok1) = out
    assert torch.equal(ok0, ok1) and int(ok0.sum()) > 400
    assert torch.equal(i0[ok0], i1[ok1])
    np.testing.assert_allclose(d1[ok1].numpy(), d0[ok0].numpy(), rtol=1e-5, atol=1e-7)


def test_ransac_banks_on_card_equal_cpu_and_repeat(cuda_device):
    """Both banks from the same minimal sets: inlier counts within 2 and
    poses within 1e-4 / 1e-3 m of the CPU (cuSOLVER's batched SVD against
    LAPACK's; degenerate samples differ, the winner does not); two runs on
    the card from equal generator seeds are bitwise equal."""
    rng = np.random.RandomState(9)
    n = 400
    X = (rng.uniform(-6, 6, (n, 3)) + [0, 0, 14.0]).astype(np.float32)
    R = np.array([[0.98, -0.05, 0.19], [0.06, 0.997, -0.04], [-0.19, 0.05, 0.98]])
    U, _, Vt = np.linalg.svd(R)
    R = (U @ Vt).astype(np.float32)
    t = np.array([0.4, -0.2, 1.0], np.float32)
    x_c = X @ R.T + t
    cam = DEFAULT_CAM
    uv = np.stack([cam.fx * x_c[:, 0] / x_c[:, 2] + cam.cx,
                   cam.fy * x_c[:, 1] / x_c[:, 2] + cam.cy], -1) + rng.randn(n, 2) * 0.5
    uv[:120] += rng.randn(120, 2) * 60.0
    uv = uv.astype(np.float32)
    valid = torch.ones(n, dtype=torch.bool)
    sel3 = minimal_sets(valid, 256, torch.Generator().manual_seed(1), k=3)
    sel6 = minimal_sets(valid, 256, torch.Generator().manual_seed(2), k=6)
    res = {}
    for dev in ("cpu", cuda_device):
        a = [torch.as_tensor(x, device=dev) for x in (X, x_c, uv)]
        ones = torch.ones(n, device=dev)
        res[str(dev)] = (
            pnp.ransac_pose_3d3d(a[0], a[1], a[2], ones.bool(), ones, cam, sel=sel3.to(dev)),
            pnp.ransac_pnp_2d3d(a[0], a[2], ones.bool(), ones, cam, sel=sel6.to(dev)))
    for r_cpu, r_gpu in zip(res["cpu"], res[str(cuda_device)]):
        assert int(r_cpu.num_inliers) > 250
        assert abs(int(r_gpu.num_inliers) - int(r_cpu.num_inliers)) <= 2
        np.testing.assert_allclose(r_gpu.pose.R.cpu().numpy(), r_cpu.pose.R.numpy(), atol=1e-4)
        np.testing.assert_allclose(r_gpu.pose.t.cpu().numpy(), r_cpu.pose.t.numpy(), atol=1e-3)
    a = [torch.as_tensor(x, device=cuda_device) for x in (X, uv)]
    ones = torch.ones(n, device=cuda_device)
    runs = []
    for _ in range(2):
        g = torch.Generator(device=cuda_device).manual_seed(7)
        runs.append(pnp.ransac_pnp_2d3d(a[0], a[1], ones.bool(), ones, cam, generator=g))
    assert torch.equal(runs[0].pose.R, runs[1].pose.R)
    assert torch.equal(runs[0].pose.t, runs[1].pose.t)
    assert torch.equal(runs[0].inliers, runs[1].inliers)


def test_two_fusion_runs_on_card_give_the_same_trajectory(cuda_device):
    """`track_fusion` over 8 frames of a small street twice: trajectories,
    keyframe poses and landmarks bitwise equal (no scatter or tie is left to
    the device's write order), LiDAR associations active, K1 and K2 launched."""
    world = planeworld.street_circuit_world(seed=0, A=24.0, B=16.0, half_width=6.0, texel=0.03,
                                            panel_spacing=8.0)
    poses, _ = planeworld.circuit_trajectory(8, A=24.0, B=16.0, corner_r=5.0, step=0.4)
    cam = synthetic.DEFAULT_CAM
    lcfg = lidar_features.LidarConfig(num_rings=32, horizon_res_deg=0.5)
    frames = []
    for i, T in enumerate(poses):
        img, _ = world.render(T, cam, H=240, W=320, noise_seed=i)
        raw = world.lidar_scan(T, planeworld.T_CAM_VELO, n_rings=32, n_azimuth=720, noise_seed=i)
        pts, T_cv = planeworld.center_scan_on_columns(raw, planeworld.T_CAM_VELO, 0.5)
        frames.append((img, pts))
    T_cl = (T_cv[:3, :3].astype(np.float32), T_cv[:3, 3].astype(np.float32))
    cfg = SystemConfig(orb=ORBConfig(max_features=1000), lidar=lcfg)
    runs = []
    for _ in range(2):
        k1, k2 = hamming.launch_count, assembly.launch_count
        s = SlamSystem(cam, cfg, device=cuda_device)
        tracked = sum(s.track_fusion(img, pts, T_cam_lidar=T_cl) is not None
                      for img, pts in frames)
        assert tracked == len(frames) and s.tracker.last_lidar_matches > 20
        assert hamming.launch_count > k1
        runs.append((s.get_trajectory(), s.store.kf_R.copy(), s.store.kf_t.copy(),
                     s.store.lm_pos.copy(), s.store.kf_flat_normal.copy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# Stereo, monocular initialization, LiDAR odometry: card against CPU
# ----------------------------------------------------------------------


def test_stereo_match_and_refinement_on_card_equal_cpu(cuda_device):
    """The same keypoints (extracted on the CPU) matched left to right and
    refined on both devices: matches exact (K1 is exact), refined u_right
    and depth within 1e-4."""
    from sqrtlm_slam_tpu_torch.frontend import orb
    from sqrtlm_slam_tpu_torch.pipeline import frame

    cam = DEFAULT_CAM._replace(bf=220.0)
    world = synthetic.SyntheticWorld(seed=4, n_points=900)
    T = synthetic.forward_trajectory(1)[0]
    img_l, _ = world.render(T, cam)
    img_r, _ = world.render(synthetic.Pose(T.R, T.t - np.array([cam.bf / cam.fx, 0, 0],
                                                                np.float32)), cam)
    cfg = ORBConfig(max_features=600)
    kps = [orb.extract(torch.as_tensor(im), cfg) for im in (img_l, img_r)]
    out = []
    for dev in ("cpu", cuda_device):
        kl, kr = (orb.Keypoints(*(x.to(dev) for x in k)) for k in kps)
        u0, _ = frame.stereo_match(kl, kr, cam.bf)
        u, d = frame.refine_stereo_subpixel(torch.as_tensor(img_l, device=dev),
                                            torch.as_tensor(img_r, device=dev), kl.xy, u0, cam.bf)
        out.append((u0.cpu(), u.cpu(), d.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and int((out[0][0] >= 0).sum()) > 100
    torch.testing.assert_close(out[1][1], out[0][1], rtol=0, atol=1e-4)
    torch.testing.assert_close(out[1][2], out[0][2], rtol=1e-5, atol=1e-4)


def _two_view_scene(planar: bool, n=150, seed=0):
    """tests/test_initializer.py's scenes made with numpy: matched pixels of
    two views 1.2 m apart, 0.3 px noise, 10% gross outliers."""
    from sqrtlm_slam_tpu_torch.geometry import so3

    rng = np.random.RandomState(seed)
    if planar:
        X = np.concatenate([rng.uniform(-5, 5, (n, 2)), np.zeros((n, 1))], 1)
        Rp = so3.exp(torch.tensor([0.3, 0.1, 0.0], dtype=torch.float64)).numpy()
        X = X @ Rp.T + [0, 0, 14.0]
    else:
        X = rng.uniform(-5, 5, (n, 3)) + [0, 0, 14.0]
    R = so3.exp(torch.tensor([0.02, -0.1, 0.01], dtype=torch.float64)).numpy()
    t = np.array([-1.2, 0.05, 0.1])
    K = np.array([[220.0, 0, 160], [0, 220, 120], [0, 0, 1]])

    def project(P):
        p = P @ K.T
        return p[:, :2] / p[:, 2:]

    uv1 = project(X)
    uv2 = project(X @ R.T + t) + rng.randn(n, 2) * 0.3
    uv2[: n // 10] += rng.randn(n // 10, 2) * 40.0
    return uv1.astype(np.float32), uv2.astype(np.float32), R, t / np.linalg.norm(t)


@pytest.mark.parametrize("planar", [False, True])
def test_initializer_banks_on_card_pick_the_cpu_motion(cuda_device, planar):
    """The same minimal sets scored with cuSOLVER's batched SVDs and with
    LAPACK's: the same model, the same motion (rotation within 1e-3 rad,
    translation direction cosine > 0.9999) and good masks on >= 99%; two
    runs on the card bitwise equal."""
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.pipeline import initializer

    uv1, uv2, R, t = _two_view_scene(planar)
    cam = Camera(220.0, 220.0, 160.0, 120.0)
    valid = torch.ones(len(uv1), dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    sel_F = minimal_sets(valid, 200, g, k=8)
    sel_H = minimal_sets(valid, 200, g, k=4)
    res = []
    for dev in ("cpu", cuda_device, cuda_device):
        r = initializer.initialize_two_view(
            torch.as_tensor(uv1, device=dev), torch.as_tensor(uv2, device=dev),
            valid.to(dev), cam, sel_F=sel_F.to(dev), sel_H=sel_H.to(dev))
        res.append(type(r)(*(type(x)(*(y.cpu() for y in x)) if isinstance(x, tuple)
                             else x.cpu() for x in r)))
    cpu, a, b = res
    assert bool(cpu.success) and bool(a.success)
    assert bool(cpu.used_homography) == bool(a.used_homography) == planar
    from sqrtlm_slam_tpu_torch.geometry import so3

    assert float(so3.log(a.T_21.R.double() @ cpu.T_21.R.double().T).norm()) < 1e-3
    assert float(a.T_21.t.double() @ cpu.T_21.t.double()) > 0.9999
    assert float((a.good == cpu.good).float().mean()) >= 0.99
    assert abs(float(a.T_21.t.double() @ torch.as_tensor(t))) > 0.995
    for x, y in zip((a.T_21.R, a.T_21.t, a.points_w, a.good), (b.T_21.R, b.T_21.t, b.points_w,
                                                               b.good)):
        assert torch.equal(x, y)


def _odometry_world(seed=7):
    """tests/test_lidar.py's kind of world, made with numpy: 300 corner
    points and 600 points on three planes, with their normals."""
    rng = np.random.RandomState(seed)
    corners = (rng.randn(300, 3) * [15.0, 6.0, 2.0]).astype(np.float32)
    normals = np.array([[0.0, 0, 1], [0, 1.0, 0], [1.0, 0, 0]], np.float32)
    offsets = np.array([1.8, -6.0, -20.0], np.float32)
    flats, ns = [], []
    for n, d in zip(normals, offsets):
        p = rng.randn(200, 3).astype(np.float32) * 8.0
        flats.append(p - (p @ n + d)[:, None] * n[None])
        ns.append(np.tile(n, (200, 1)))
    return corners, np.concatenate(flats).astype(np.float32), np.concatenate(ns)


def test_align_scan_on_card_equals_cpu_and_repeats(cuda_device):
    from sqrtlm_slam_tpu_torch.geometry import se3
    from sqrtlm_slam_tpu_torch.lidar import odometry

    corners, flats, normals = _odometry_world()
    pose_true = se3.exp(torch.tensor([0.5, -0.3, 0.2, 0.03, -0.02, 0.05]))
    pose0 = se3.retract(pose_true, torch.tensor([0.3, 0.2, -0.2, 0.02, 0.03, -0.02]))
    cfg = odometry.OdomConfig()
    out = []
    for dev in ("cpu", cuda_device, cuda_device):
        def T(a):
            return torch.as_tensor(a, device=dev)

        lm = odometry.build_local_map(T(corners), T(np.ones(300, bool)), T(flats),
                                      T(np.ones(600, bool)), T(normals), cfg)
        p_true = se3.SE3(pose_true.R.to(dev), pose_true.t.to(dev))
        c_s = se3.act(p_true, T(corners[:150]))
        f_s = se3.act(p_true, T(flats[::2]))
        pose, stats = odometry.align_scan(se3.SE3(pose0.R.to(dev), pose0.t.to(dev)), c_s,
                                          T(np.ones(150, bool)), f_s, T(np.ones(300, bool)), lm,
                                          cfg)
        out.append((pose.R.cpu(), pose.t.cpu(), int(stats["matches"])))
    (R0, t0, m0), (R1, t1, m1), (R2, t2, m2) = out
    assert m0 == m1 == m2 > 300
    torch.testing.assert_close(R1, R0, rtol=0, atol=1e-5)
    torch.testing.assert_close(t1, t0, rtol=0, atol=1e-5)
    assert torch.equal(R1, R2) and torch.equal(t1, t2)


def test_se3_pose_graph_on_card_repeats_bitwise(cuda_device):
    """Two backend runs on the card give bitwise-equal poses (fixed-order
    block sums, no atomics); rotations within 1e-4 of the CPU, positions
    within 5e-4 m + 1e-4 relative."""
    from sqrtlm_slam_tpu_torch.geometry import se3
    from sqrtlm_slam_tpu_torch.lidar import backend

    rng = np.random.RandomState(0)
    chain = [se3.identity()]
    for _ in range(29):
        step = torch.as_tensor(np.array([0.5, 0.02, 0.0, 0, 0, 0.02]) + rng.normal(0, 0.03, 6)
                               * [1, 1, 1, 0.2, 0.2, 0.2], dtype=torch.float32)
        chain.append(se3.compose(se3.exp(step), chain[-1]))
    loop = [(0, 29, se3.SE3(chain[29].R, chain[29].t + torch.tensor([0.3, -0.2, 0.1])))]
    anchors = [(10, np.array([0.1, 5.0, 0.0]))]
    out = []
    for dev in ("cpu", cuda_device, cuda_device):
        c = [se3.SE3(p.R.to(dev), p.t.to(dev)) for p in chain]
        edges = [(i, j, se3.SE3(T.R.to(dev), T.t.to(dev))) for i, j, T in loop]
        g, chi2 = backend.optimize_se3_graph(backend.build_chain_graph(c, edges, anchors=anchors),
                                             num_iters=20)
        out.append((g.R.cpu(), g.t.cpu(), chi2.cpu()))
    assert torch.equal(out[1][0], out[2][0]) and torch.equal(out[1][1], out[2][1])
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-4)
    # Positions up to ~15 m: float32 sums in another order move them by
    # ~1e-5 relative (1.8e-4 m measured on the H100).
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-4, atol=5e-4)
    torch.testing.assert_close(out[1][2], out[0][2], rtol=1e-3, atol=1e-6)


def test_search_and_fuse_on_card_equals_cpu_on_the_same_inputs(cuda_device):
    """The ring loop of tests/test_e2e_loop.py on the card to its first loop;
    the loop closer's inputs there (map, keyframe pair, S12, matches) go
    through `correct_loop` (global BA off) on the card and on the CPU: the
    same landmarks are merged into the same keypoints. (Over whole runs the
    merge counts differ between the devices; scripts/fuse_divergence.py
    traces that upstream.)"""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "fuse_divergence.py")
    spec = importlib.util.spec_from_file_location("fuse_divergence", path)
    fd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fd)
    capture, summary = fd.run_to_first_loop(fd.ring_frames(160), cuda_device)
    assert capture is not None, summary
    m_gpu, ok_gpu = fd.replay(capture, cuda_device)
    m_cpu, ok_cpu = fd.replay(capture, torch.device("cpu"))
    assert ok_gpu and ok_cpu and len(m_gpu) >= 20
    assert m_gpu == m_cpu, (len(m_gpu), len(m_cpu))
