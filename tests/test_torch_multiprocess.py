"""Distributed BA across OS processes in the port: `python -m
sqrtlm_slam_tpu_torch.parallel.mp_worker` ranks joined by `torch.distributed`
with the gloo backend on the CPU.

Two processes x two shards against the in-process run over four shards
(the same protocol; the all-reduce adds the two processes' partial sums in
another order: accepted equal, chi2 rtol 1e-4, pose_t atol 1e-4, points
atol 1e-4 plus rtol 5e-5, as landmarks lie 10-25 m out) and against the JAX package's distributed LM over a 4-device CPU mesh
(tests/test_multiprocess.py's gates: accepted within 1, chi2 rtol 0.05,
pose_t atol 5e-3, points 2e-2). Every rank's result is bitwise equal (the
workers print a SHA-256 digest of their poses, landmarks and chi2).
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
from jax.sharding import Mesh

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM as J_CAM
from sqrtlm_slam_tpu.optim import schur as j_schur
from sqrtlm_slam_tpu.optim import schur_bucketed as j_sb
from sqrtlm_slam_tpu.parallel import dist_ba as j_dist
from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_sb
from sqrtlm_slam_tpu_torch.parallel import dist_ba as t_dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The worker's defaults (the JAX worker's shape).
POSES, LANDMARKS, OBS_PER_LM, ITERS, SEED = 5, 48, 5, 6, 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(nproc: int, shards_per_proc: int, out_path: str):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sqrtlm_slam_tpu_torch.parallel.mp_worker",
         "--coordinator", f"localhost:{port}", "--nproc", str(nproc), "--pid", str(pid),
         "--shards-per-proc", str(shards_per_proc), "--device", "cpu",
         "--poses", str(POSES), "--landmarks", str(LANDMARKS), "--obs-per-lm", str(OBS_PER_LM),
         "--iters", str(ITERS), "--seed", str(SEED), "--out", out_path],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


def _problem():
    flat, _ = make_ba_problem(seed=SEED, P=POSES, L=LANDMARKS, obs_per_landmark=OBS_PER_LM)
    return flat, t_sb.from_flat(flat, K=OBS_PER_LM, device="cpu")


def _check(results, out_path, nproc, shards):
    assert [r["rank"] for r in results] == list(range(nproc))
    assert all(r["shards"] == shards and r["backend"] == "gloo" for r in results)
    assert len({r["digest"] for r in results}) == 1, results  # ranks bitwise equal
    got = np.load(out_path)
    assert int(got["n_shards"]) == shards
    flat, b = _problem()
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref, chi2_ref, acc_ref = t_dist.distributed_ba_lm(b, DEFAULT_CAM, t_dist.make_mesh(4, "cpu"),
                                                          num_iters=ITERS)
    finally:
        torch.set_num_threads(prev)
    assert int(got["n_acc"]) == int(acc_ref)
    np.testing.assert_allclose(float(got["chi2"]), float(chi2_ref), rtol=1e-4)
    np.testing.assert_allclose(got["pose_t"], ref.pose_t.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["points"], ref.points.numpy(), atol=1e-4, rtol=5e-5)
    return got, flat


def test_cameras_agree():
    assert tuple(J_CAM) == tuple(DEFAULT_CAM)


def test_two_processes_two_shards_each_match_in_process_and_jax(tmp_path):
    out_path = str(tmp_path / "mp.npz")
    results = _launch(2, 2, out_path)
    got, flat = _check(results, out_path, nproc=2, shards=4)
    # The JAX package's distributed LM over 4 devices on the same problem.
    jflat = j_schur.BAProblem(*[jnp.asarray(np.asarray(x)) for x in flat])
    jb = j_sb.from_flat(jflat, K=OBS_PER_LM)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("ba",))
    want, chi2_j, acc_j = j_dist.distributed_ba_lm(jb, J_CAM, mesh, num_iters=ITERS)
    assert abs(int(got["n_acc"]) - int(acc_j)) <= 1
    np.testing.assert_allclose(float(got["chi2"]), float(chi2_j), rtol=0.05)
    np.testing.assert_allclose(got["pose_t"], np.asarray(want.pose_t), atol=5e-3)
    np.testing.assert_allclose(got["points"], np.asarray(want.points), atol=2e-2)


@pytest.mark.slow
def test_four_processes_one_shard_each(tmp_path):
    """Every sum crosses a process boundary."""
    out_path = str(tmp_path / "mp4.npz")
    _check(_launch(4, 1, out_path), out_path, nproc=4, shards=4)
