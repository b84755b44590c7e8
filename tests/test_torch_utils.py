"""Utilities of the port against the JAX package: the sequence config and
its YAML loader, the stage timer, the plots, the Kalman filter (within
1e-6) and the extrinsic calibration (within 1e-4), on the same inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sqrtlm_slam_tpu.factors import calibration as j_calib
from sqrtlm_slam_tpu.geometry import se3 as j_se3
from sqrtlm_slam_tpu.utils import config as j_config
from sqrtlm_slam_tpu.utils import kalman as j_kalman
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.factors import calibration as t_calib
from sqrtlm_slam_tpu_torch.geometry import se3 as t_se3
from sqrtlm_slam_tpu_torch.utils import StageTimer, TicToc
from sqrtlm_slam_tpu_torch.utils import config as t_config
from sqrtlm_slam_tpu_torch.utils import kalman as t_kalman


def test_yaml_config_equals_the_jax_package(tmp_path):
    """Reference-style OpenCV-YAML keys + section overrides both apply."""
    p = tmp_path / "cfg.yaml"
    p.write_text("ORBextractor.nFeatures: 1234\n"
                 "ORBextractor.scaleFactor: 1.25\n"
                 "ThDepth: 99\n"
                 "tracking:\n  close_depth: 33.0\n  pipelined: true\n"
                 "orb:\n  fast_threshold: 12\n  unknown_key: 3\n")
    got, want = t_config.load_yaml_config(str(p)), j_config.load_yaml_config(str(p))
    assert got.orb.max_features == 1234 and got.tracking.close_depth == 33.0
    assert got.tracking.pipelined and got.th_depth_scale == 99.0
    assert got.orb == convert.orb_config(want.orb)
    assert got.tracking == convert.tracking_config(want.tracking)
    assert got.lidar == convert.lidar_config(want.lidar)
    assert got.th_depth_scale == want.th_depth_scale
    base = t_config.kitti_sequence_config("00")
    assert base.orb == convert.orb_config(j_config.kitti_sequence_config("00").orb)
    assert base.tracking == convert.tracking_config(j_config.kitti_sequence_config().tracking)


def test_tictoc_and_stage_timer():
    t = TicToc()
    assert t.toc() >= 0.0
    st = StageTimer()
    for _ in range(2):
        with st.stage("a"):
            pass
    try:
        with st.stage("b"):
            raise KeyError("inside a stage")
    except KeyError:
        pass
    assert st.counts["a"] == 2 and st.counts["b"] == 1
    assert "a" in st.summary() and "b" in st.summary()


def test_plot_trajectory(tmp_path):
    from sqrtlm_slam_tpu_torch.eval.plot import plot_trajectory

    est = np.tile(np.eye(4), (20, 1, 1))
    est[:, 0, 3] = np.linspace(0, 10, 20)
    gt = est.copy()
    gt[:, 2, 3] = 0.1
    lm = np.random.RandomState(0).randn(100, 3)
    out = plot_trajectory(str(tmp_path / "traj.png"), est, gt=gt,
                          comparisons={"prior": gt}, landmarks=lm)
    assert os.path.getsize(out) > 1000


def test_render_slam_result(tmp_path):
    from sqrtlm_slam_tpu_torch.eval.plot import render_slam_result

    rng = np.random.default_rng(0)
    res = {
        "state": 2, "ref_kf": 1, "num_inliers": 99,
        "kf_ids": np.arange(3),
        "kf_R": np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)),
        "kf_t": rng.normal(size=(3, 3)).astype(np.float32),
        "map_points": rng.normal(size=(200, 3)),
        "local_map_points": rng.normal(size=(40, 3)),
        "trajectory": np.tile(np.eye(4), (10, 1, 1)),
        "lidar_corner": rng.normal(size=(20, 3)),
        "lidar_flat": rng.normal(size=(100, 3)),
    }
    out = render_slam_result(res, str(tmp_path / "snap.png"),
                             depth_image=rng.random((32, 64)), range_image=rng.random((16, 90)))
    assert os.path.getsize(out) > 10000


def test_kalman_equals_the_jax_package():
    """tests/test_utils.py's constant-velocity track: init / predict /
    update / step of both packages on the same measurements, within 1e-6."""
    rng = np.random.RandomState(0)
    v = np.array([1.0, 0.5, -0.2], np.float32)
    js = j_kalman.init(jnp.zeros(3), pos_var=10.0)
    ts = t_kalman.init(torch.zeros(3), pos_var=10.0)
    for k in range(1, 40):
        z = (v * k * 0.1 + rng.normal(0, 0.01, 3)).astype(np.float32)
        if k % 3 == 0:  # predict and update apart, with other variances
            js = j_kalman.update(j_kalman.predict(js, 0.1, 2.0), jnp.asarray(z), 0.02)
            ts = t_kalman.update(t_kalman.predict(ts, 0.1, 2.0), torch.as_tensor(z), 0.02)
        else:
            js = j_kalman.step(js, jnp.asarray(z), dt=0.1)
            ts = t_kalman.step(ts, torch.as_tensor(z), dt=0.1)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.x[3:].numpy(), v, atol=0.05)


def test_calibrate_extrinsics_equals_the_jax_package():
    """tests/test_lidar_modes.py's problem (point pairs and planes, from its
    key): the port's refined extrinsic within 1e-4 of the JAX package's."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    T_true = j_se3.exp(jnp.array([0.1, -0.05, 0.2, 0.03, -0.01, 0.04]))
    p_l = jax.random.normal(k1, (200, 3)) * 5.0
    q_c = j_se3.act(T_true, p_l) + jax.random.normal(k2, (200, 3)) * 1e-3
    n_c = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (100, 1))
    d_c = -j_se3.act(T_true, p_l[:100])[:, 2]
    want = j_calib.calibrate_extrinsics(
        j_se3.identity(), p_l, q_c, jnp.ones(200, bool), plane_p=p_l[:100], plane_n=n_c,
        plane_d=d_c, plane_valid=jnp.ones(100, bool))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a)).to(dtype)

    got = t_calib.calibrate_extrinsics(
        t_se3.identity(), t(p_l), t(q_c), torch.ones(200, dtype=torch.bool),
        plane_p=t(p_l[:100]), plane_n=t(n_c), plane_d=t(d_c),
        plane_valid=torch.ones(100, dtype=torch.bool))
    np.testing.assert_allclose(got.T.R.numpy(), np.asarray(want.T.R), atol=1e-4)
    np.testing.assert_allclose(got.T.t.numpy(), np.asarray(want.T.t), atol=1e-4)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3, atol=1e-4)
    err = t_se3.local_delta(got.T, convert.se3(T_true))
    assert float(torch.linalg.norm(err)) < 1e-3 and float(got.chi2) < 1e-2
    # One step of the residuals and Jacobians alone.
    T0 = convert.se3(j_se3.exp(jnp.array([0.02, 0.01, -0.03, 0.01, 0.02, -0.01])))
    Tj = j_se3.exp(jnp.array([0.02, 0.01, -0.03, 0.01, 0.02, -0.01]))
    r, J = t_calib.point_pair_residual_jac(T0, t(p_l), t(q_c))
    rj, Jj = j_calib.point_pair_residual_jac(Tj, p_l, q_c)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-4)
    r, J = t_calib.point_plane_residual_jac(T0, t(p_l[:100]), t(n_c), t(d_c))
    rj, Jj = j_calib.point_plane_residual_jac(Tj, p_l[:100], n_c, d_c)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-4)
