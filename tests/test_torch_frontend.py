"""Port frontend (ORB, depth association) and data generators vs the JAX package.

Same seeded inputs to both packages. The keypoint stage (FAST scores, grid
top-k with lower-index ties, keypoint set, octaves) is held exact. The
descriptors carry a measured residual, bounded below: the pyramid levels
come from matrix products whose float32 summation order differs from XLA's
(XLA rewrites the weight math and contracts in Eigen's order), and the
synthetic textures are binary, so many BRIEF pairs compare two pixels that
are equal up to that rounding. Over 7 frames of the scene below (3730
keypoints): 80% of descriptors identical, mean 0.62 of 256 bits, max 18;
level 0 (no resize): 99.7% identical, max 1 bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import synthetic as j_synth
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import synthetic as t_synth
from sqrtlm_slam_tpu_torch.frontend import orb as t_orb
from sqrtlm_slam_tpu_torch.pipeline import frame as t_frame
from sqrtlm_slam_tpu_torch.utils import desc_to_numpy

CFG = j_orb.ORBConfig(max_features=600)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    world = j_synth.SyntheticWorld(seed=3, n_points=900)
    poses = j_synth.forward_trajectory(25, step=0.4)
    frames = [world.render(poses[i], j_synth.DEFAULT_CAM) for i in (0, 12)]
    return world, poses, [(np.array(a), np.array(b)) for a, b in frames]


@pytest.fixture(scope="module")
def extracted(scene):
    ext = jax.jit(j_orb.extract, static_argnames=("cfg",))
    out = []
    for img, depth in scene[2]:
        out.append((ext(jnp.asarray(img), CFG),
                    t_orb.extract(torch.as_tensor(img), convert.orb_config(CFG))))
    return out


def test_render_is_bit_identical(scene):
    world, poses, _ = scene
    tw = t_synth.SyntheticWorld(seed=3, n_points=900)
    np.testing.assert_array_equal(tw.points, world.points)
    for i in (0, 7, 24):
        a_img, a_depth = world.render(poses[i], j_synth.DEFAULT_CAM)
        b_img, b_depth = tw.render(poses[i], t_synth.DEFAULT_CAM)
        np.testing.assert_array_equal(b_img, np.asarray(a_img))
        np.testing.assert_array_equal(b_depth, np.asarray(a_depth))


def test_forward_trajectory_matches():
    want = j_synth.forward_trajectory(25, step=0.4)
    got = t_synth.forward_trajectory(25, step=0.4)
    for a, b in zip(got, want):
        # float32 SE(3) chain of 25 composes: agreement to float32 rounding.
        np.testing.assert_allclose(a.R, np.asarray(b.R), atol=2e-6)
        np.testing.assert_allclose(a.t, np.asarray(b.t), atol=2e-5)


def test_make_ba_problem_shapes_and_noise():
    flat, (R_true, t_true) = t_synth.make_ba_problem(seed=0, P=16, L=512, obs_per_landmark=4)
    assert flat.obs_cam.shape == (512 * 4,) and flat.pose_R.shape == (16, 3, 3)
    assert flat.pose_fixed[:2].all() and not flat.pose_fixed[2:].any()
    np.testing.assert_allclose(flat.pose_R[:2], R_true[:2], atol=1e-6)
    stereo = flat.obs_uvr[:, 2] >= 0
    assert 0.4 < stereo.mean() < 0.8


def test_fast_and_grid_topk_exact(scene):
    img = scene[2][1][0]
    hi_j, lo_j = j_orb.fast_scores_dual(jnp.asarray(img), 20.0, 7.0)
    hi_t, lo_t = t_orb.fast_scores_dual(torch.as_tensor(img), 20.0, 7.0)
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    xy_j, s_j = j_orb.grid_topk(hi_j, 32, 4, 300, lo_j)
    xy_t, s_t = t_orb.grid_topk(hi_t, 32, 4, 300, lo_t)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_grid_topk_ties_break_to_lower_index():
    score = np.zeros((64, 64), np.float32)
    score[5:60:3, 7:60:5] = 3.0  # many exact ties
    xy_j, s_j = j_orb.grid_topk(jnp.asarray(score), 32, 4, 10)
    xy_t, s_t = t_orb.grid_topk(torch.as_tensor(score), 32, 4, 10)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_moments_blur_and_resize_close(scene):
    img = scene[2][0][0]
    m10_j, m01_j = j_orb._orientation_maps(jnp.asarray(img), 31)
    m10_t, m01_t = t_orb._orientation_maps(torch.as_tensor(img), 31)
    # Span sums of ~1e5-scale prefix sums: float32 rounding of that scale.
    scale = float(np.abs(np.asarray(m10_j)).max())
    np.testing.assert_allclose(m10_t.numpy(), np.asarray(m10_j), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(m01_t.numpy(), np.asarray(m01_j), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(t_orb.gaussian_blur(torch.as_tensor(img)).numpy(),
                               np.asarray(j_orb.gaussian_blur(jnp.asarray(img))), atol=1e-4)
    for h, w in ((200, 267), (67, 89)):
        want = np.asarray(jax.image.resize(jnp.asarray(img), (h, w), method="linear"))
        got = t_orb.resize_linear(torch.as_tensor(img), h, w).numpy()
        # Pixel values <= 255: float32 summation-order differences only.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_cumsum_rows_reproduces_xla_order():
    rng = np.random.RandomState(0)
    for n in (5, 16, 320, 1226):
        a = (rng.rand(3, n) * 230).astype(np.float32)
        want = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=1))(a))
        np.testing.assert_array_equal(t_orb._cumsum_rows(torch.as_tensor(a)).numpy(), want)


def test_extract_keypoints_exact_descriptor_residual_bounded(extracted):
    for kj, kt in extracted:
        valid = np.asarray(kj.valid)
        np.testing.assert_array_equal(kt.valid.numpy(), valid)
        np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
        np.testing.assert_array_equal(kt.octave.numpy(), np.asarray(kj.octave))
        np.testing.assert_allclose(kt.score.numpy(), np.asarray(kj.score), atol=1e-2)
        np.testing.assert_allclose(kt.angle.numpy()[valid], np.asarray(kj.angle)[valid],
                                   atol=1e-3)
        x = np.asarray(kj.desc) ^ desc_to_numpy(kt.desc)
        bits = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)[valid]
        lvl0 = np.asarray(kj.octave)[valid] == 0
        # Bounds from the measured residual (see module docstring).
        assert (bits[lvl0] == 0).mean() >= 0.98 and bits[lvl0].max() <= 2
        assert (bits == 0).mean() >= 0.7
        assert bits.mean() <= 1.5 and bits.max() <= 32


def test_associate_depth_and_build_frame_match(scene, extracted):
    img, depth = scene[2][1]
    kj, kt = extracted[1]
    d_j, s_j = j_frame.associate_depth(jnp.asarray(depth), kj.xy)
    d_t, s_t = t_frame.associate_depth(torch.as_tensor(depth), kt.xy)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    cam = j_synth.DEFAULT_CAM
    fj = j_frame.build_frame_jit(jnp.asarray(img), cam, CFG, depth_img=jnp.asarray(depth))
    ft = t_frame.build_frame(torch.as_tensor(img), convert.camera(cam),
                             convert.orb_config(CFG), depth_img=torch.as_tensor(depth))
    np.testing.assert_array_equal(ft.depth.numpy(), np.asarray(fj.depth))
    np.testing.assert_allclose(ft.uvr.numpy(), np.asarray(fj.uvr), atol=1e-4)
    np.testing.assert_array_equal(ft.inv_sigma2.numpy(), np.asarray(fj.inv_sigma2))
