"""The port's KITTI runner, `python -m sqrtlm_slam_tpu_torch.run_kitti`.

On tests/test_runner.py's mini KITTI-layout tree (240x320, 6 frames of the
synthetic world, scans back-projected from the depth images) the runner
runs on the CPU in `depth`, `lidar` and `fusion --async-mapping
--pipelined`, each in a subprocess that never imports jax; the summary's
keys, the tracked count and the trajectory file are checked. `slow`: the
port's runner beside `run_kitti.py` on the same tree, and
tests/test_planeworld_fusion.py's 30 KITTI-size frames through the port.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Camera -> velodyne basis (x_l = z_c, y_l = -x_c, z_l = -y_c).
R_CL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
JSON_KEYS = {"seq", "mode", "frames", "frames_per_s", "ate_rmse_m", "peak_rss_gb"}
SLAM_KEYS = JSON_KEYS | {"tracked", "keyframes", "landmarks"}


def make_mini_kitti(root, n_frames=6):
    """tests/test_runner.py's tree, from the port's (identical) renderer."""
    seq_dir = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq_dir, "image_0"))
    os.makedirs(os.path.join(seq_dir, "velodyne"))
    os.makedirs(os.path.join(root, "poses"))
    cam = DEFAULT_CAM
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        Tr = " ".join(str(x) for x in np.hstack([R_CL, np.zeros((3, 1))]).reshape(-1))
        f.write(f"P0: {cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
                f"P1: {cam.fx} 0 {cam.cx} {-cam.bf} 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
                f"Tr: {Tr}\n")
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.writelines(f"{i * 0.1:.6f}\n" for i in range(n_frames))
    world = SyntheticWorld(seed=2, n_points=1000)
    gt_lines = []
    for i, T in enumerate(forward_trajectory(n_frames, step=0.35)):
        img, d = world.render(T, cam)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(seq_dir, "image_0", f"{i:06d}.png"))
        # Back-project the depth image -> camera cloud -> velodyne frame.
        vs, us = np.mgrid[0:d.shape[0]:2, 0:d.shape[1]:2]
        z = d[::2, ::2].reshape(-1)
        sel = z > 0
        p_c = np.stack([(us.reshape(-1)[sel] - cam.cx) * z[sel] / cam.fx,
                        (vs.reshape(-1)[sel] - cam.cy) * z[sel] / cam.fy, z[sel]],
                       -1).astype(np.float32)
        rec = np.concatenate([p_c @ R_CL, np.ones((int(sel.sum()), 1), np.float32)], -1)
        rec.tofile(os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = T.R, T.t
        gt_lines.append(" ".join(f"{v:.9e}" for v in np.linalg.inv(M)[:3].reshape(-1)))
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_runner_port") / "kitti")
    os.makedirs(root)
    make_mini_kitti(root)
    return root


def _runner(argv, threads=2):
    """A process that runs the module as `python -m` does, then fails if jax
    or the JAX package was ever imported. Prints the summary line last."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads({threads})
        sys.argv = ["run_kitti"] + {argv!r}
        runpy.run_module("sqrtlm_slam_tpu_torch.run_kitti", run_name="__main__")
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "sqrtlm_slam_tpu")]
        assert not bad, bad
    """)
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_runner_on_the_cpu_without_jax(mini_root, tmp_path):
    plot, prof = str(tmp_path / "plot.png"), str(tmp_path / "prof")
    modes = {
        "depth": ["--mode", "depth", "--plot", plot, "--viz-every", "3"],
        "lidar": ["--mode", "lidar", "--profile", prof],
        "fusion": ["--mode", "fusion", "--async-mapping", "--pipelined"],
    }
    procs = {}
    for name, extra in modes.items():
        out = str(tmp_path / f"traj_{name}.txt")
        procs[name] = (out, _runner(["--root", mini_root, "--seq", "00", "--out", out,
                                     "--max-features", "600", "--json", "--device", "cpu",
                                     *extra]))
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, stderr[-3000:])
        result = json.loads(stdout.strip().splitlines()[-1])
        traj = np.loadtxt(out)
        assert traj.shape == (6, 12), name
        assert result["frames"] == 6 and result["device"] == "cpu"
        assert result["loader"] in ("native", "python")
        if name == "lidar":
            assert JSON_KEYS <= set(result), result
            assert np.isfinite(traj).all()
        else:
            assert SLAM_KEYS <= set(result), result
            assert result["tracked"] == 6 and result["keyframes"] >= 2, result
            assert result["ate_rmse_m"] < 0.3, result
            assert result["wall_s"] >= result["drain_s"] >= 0.0
        stage = "lidar_odometry" if name == "lidar" else "shutdown"
        assert "ATE RMSE" in stderr and stage in stderr, stderr
    for path in (plot, plot[:-4] + "_live.png", plot[:-4] + "_snapshot.png",
                 os.path.join(prof, "trace_00_lidar.json")):
        assert os.path.getsize(path) > 1000, path


def test_runner_refuses_a_missing_card(mini_root, tmp_path, monkeypatch):
    """No automatic CPU fallback: `--device cuda` without a card exits."""
    import torch

    from sqrtlm_slam_tpu_torch import run_kitti

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_kitti.main(["--root", mini_root, "--seq", "00", "--out",
                        str(tmp_path / "t.txt")])


@pytest.mark.slow
def test_runner_beside_run_kitti_py(mini_root, tmp_path):
    """The same tree through `run_kitti.py` (JAX) and the port: the same
    tracked count, keyframes within 1, ATE within 0.02 m."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = {}
    for name, cmd in (("jax", [sys.executable, "run_kitti.py"]),
                      ("port", [sys.executable, "-m", "sqrtlm_slam_tpu_torch.run_kitti",
                                "--device", "cpu"])):
        out = str(tmp_path / f"{name}.txt")
        proc = subprocess.run(cmd + ["--root", mini_root, "--seq", "00", "--mode", "depth",
                                     "--out", out, "--max-features", "600", "--json"],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, (name, proc.stderr[-2000:])
        res[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["port"]["tracked"] == res["jax"]["tracked"] == 6
    assert abs(res["port"]["keyframes"] - res["jax"]["keyframes"]) <= 1
    assert abs(res["port"]["ate_rmse_m"] - res["jax"]["ate_rmse_m"]) < 0.02, res


@pytest.mark.slow
def test_kitti_layout_fusion_reference_gates(tmp_path):
    """tests/test_planeworld_fusion.py on the port: 30 KITTI-size frames of
    the generator's street through `--mode fusion` with the default gates."""
    from sqrtlm_slam_tpu_torch.eval.kitti_synth import generate

    root = str(tmp_path / "kitti")
    n = 30
    generate(root, seq="00", n_frames=n, seed=0, step=0.8, log=lambda *a: None)
    proc = subprocess.run(
        [sys.executable, "-m", "sqrtlm_slam_tpu_torch.run_kitti", "--root", root,
         "--seq", "00", "--mode", "fusion", "--frames", str(n), "--out",
         str(tmp_path / "traj.txt"), "--json", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["tracked"] == n, summary
    assert summary["ate_rmse_m"] < 0.5, summary
    assert summary["keyframes"] >= 2, summary


@pytest.mark.slow
def test_longrun_and_place_recognition_beside_the_jax_package():
    """`eval/longrun.run_long` over a short stretch of the ring, then the
    place-recognition precision / recall of both packages' functions on the
    port's store (the numpy MapStore is the same class in both)."""
    from sqrtlm_slam_tpu.eval import longrun as j_longrun
    from sqrtlm_slam_tpu.eval import synthetic as j_synthetic
    from sqrtlm_slam_tpu_torch.eval import longrun

    out, s = longrun.run_long(n_frames=12, radius=12.0, revolutions=0.1, n_points=2500,
                              max_features=600, progress_every=0, device="cpu",
                              log=lambda *a: None)
    assert out["tracked"] == 12 and out["keyframes"] >= 2 and out["ate_rmse_m"] < 0.1, out
    gt = j_synthetic.ring_trajectory(12, radius=12.0, frac=0.1)
    kw = dict(min_gap=2, dist_thresh=6.0, log=lambda *a: None)
    assert (longrun.evaluate_place_recognition(s, gt, **kw)
            == j_longrun.evaluate_place_recognition(s, gt, **kw))
