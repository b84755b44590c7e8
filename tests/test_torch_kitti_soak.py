"""The fusion soak's pieces on the CPU: the KITTI-layout sequence writer
(`eval/kitti_synth.generate` in a process pool, and with the centred
64 x 1800-ray scans), the soak script (`scripts/kitti_soak_reference.py`)
and its gates (`eval/kitti_soak.gates`).

- The pool writes the bytes of one process, which are the JAX package's
  generator's; with `centred=True` it writes the bytes of the serial
  generator followed by the rescan that the KITTI runner's smoke phase
  made before it used the writer (64 x 1800 rays through
  `planeworld.center_scan_on_columns`, `Tr` to match). First 3 frames.
- The script over a 6-frame sequence through the port's runner: its
  RESULT's fields, progress readings and the digest of what it read; the
  gates pass a run against itself and name each gate a changed reference
  breaks.
- `-m slow`: the first 30 frames through both packages' runners
  (`run_kitti.py` and the port's) at the reference's gates, the
  counterpart of tests/test_planeworld_fusion.py, outcomes compared.
"""

import filecmp
import importlib.util
import os

import numpy as np
import pytest

from sqrtlm_slam_tpu_torch.eval import kitti_soak, kitti_synth, planeworld

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The runs take 2 CPU threads (restored after the module)."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def street():
    return planeworld.street_circuit_world(seed=0)


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def _same_tree(a, b):
    names = _tree(a)
    assert names == _tree(b)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n


def _rescan_as_the_runner_phase_did(root, n_frames, street):
    """The KITTI runner's smoke phase before the writer took it over: the
    generator's 1440-ray scans rewritten as 64 x 1800 rays on the columns,
    and the Tr that goes with them."""
    seq_dir = os.path.join(root, "sequences", "00")
    poses, _ = planeworld.circuit_trajectory(n_frames, step=0.8)
    for i, T in enumerate(poses):
        scan = street.lidar_scan(T, planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=i)
        pts, T_cv = planeworld.center_scan_on_columns(scan, planeworld.T_CAM_VELO)
        np.concatenate([pts, scan[:, 3:4]], axis=1).astype(np.float32).tofile(
            os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))
    calib = os.path.join(seq_dir, "calib.txt")
    with open(calib) as f:
        rows = [ln for ln in f.read().splitlines() if not ln.startswith("Tr:")]
    with open(calib, "w") as f:
        f.write("\n".join(rows + ["Tr: " + " ".join(repr(float(x)) for x in T_cv[:3].ravel())])
                + "\n")


def test_pool_writes_the_serial_and_the_jax_generators_bytes(tmp_path, street):
    from sqrtlm_slam_tpu.eval import kitti_synth as j_kitti_synth

    quiet = dict(n_frames=3, log=lambda *a: None)
    kitti_synth.generate(str(tmp_path / "serial"), world=street, **quiet)
    kitti_synth.generate(str(tmp_path / "pool"), world=street, workers=3, **quiet)
    j_kitti_synth.generate(str(tmp_path / "jax"), **quiet)
    _same_tree(tmp_path / "serial", tmp_path / "pool")
    _same_tree(tmp_path / "serial", tmp_path / "jax")

    kitti_synth.generate(str(tmp_path / "centred"), world=street, workers=2, centred=True,
                         **quiet)
    _rescan_as_the_runner_phase_did(str(tmp_path / "serial"), 3, street)
    _same_tree(tmp_path / "serial", tmp_path / "centred")
    assert kitti_soak.digest(str(tmp_path / "serial")) == kitti_soak.digest(
        str(tmp_path / "centred"))


def _script():
    spec = importlib.util.spec_from_file_location(
        "kitti_soak_reference", os.path.join(REPO, "scripts", "kitti_soak_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def six_frames(tmp_path_factory, street):
    root = str(tmp_path_factory.mktemp("soak") / "kitti")
    kitti_synth.generate(root, n_frames=6, world=street, centred=True, log=lambda *a: None)
    return root


def test_soak_script_result_and_gates(six_frames, tmp_path, capsys):
    record = str(tmp_path / "port.json")
    res = _script().main(["--package", "port", "--root", six_frames, "--every", "3",
                          "--out", str(tmp_path / "traj.txt"), "--record", record])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("PROGRESS")] == ["frame=3",
                                                                            "frame=6"]
    assert lines[-1].startswith("RESULT {")
    for key in ("frames", "tracked", "lost_frames", "keyframes", "keyframes_created",
                "landmarks", "landmarks_created", "loops_closed", "loops_vetoed",
                "loop_events", "first_loop_frame", "relocalisations", "gba", "ate_rmse_m",
                "ate_m_of_first", "peak_rss_mb", "progress", "runner", "sequence_digest"):
        assert key in res, key
    assert res["frames"] == res["tracked"] == 6 and res["lost_frames"] == 0
    assert res["keyframes_created"] >= res["keyframes"] >= 1
    assert res["landmarks_created"] >= res["landmarks"] > 100
    assert res["ate_rmse_m"] < 0.1 and res["ate_m_of_first"] == {}
    assert res["runner"]["tracked"] == 6 and res["runner"]["loader"] in ("native", "python")
    assert [r["frame"] for r in res["progress"]] == [3, 6]
    assert res["progress"][-1]["keyframes_created"] == res["keyframes_created"]
    assert res["sequence_digest"] == kitti_soak.digest(six_frames)
    assert os.path.getsize(record) > 0

    assert kitti_soak.gates(res, res) == []
    ref = dict(res, tracked=7, keyframes_created=10 * res["keyframes_created"],
               landmarks_created=2 * res["landmarks_created"],
               loops_closed=1, ate_m_of_first={"100": 0.01})
    bad = kitti_soak.gates(res, ref)
    assert [b.split()[0] for b in bad] == ["tracked", "keyframes_created", "landmarks_created",
                                          "0"]
    assert kitti_soak.gates(res, ref, loops_explained="vetoed by drift")[-1].startswith(
        "landmarks_created")


def test_gates_on_prefix_ates_and_depth():
    f = kitti_soak.PREFIX_ATE_FACTOR
    ref = dict(frames=500, tracked=500, keyframes_created=100, landmarks_created=50000,
               loops_closed=1, ate_m_of_first={"100": 0.2, "200": 0.4, "500": 1.0},
               progress=[dict(frame=250, tracked=250, keyframes_created=50,
                              landmarks_created=25000, loops_closed=0,
                              ate_m_of_first={"100": 0.1, "200": 0.3})])
    got = dict(ref, ate_m_of_first={100: 0.2 * f, 200: 0.41 * f, 500: 0.9 * f})
    assert kitti_soak.gates(got, ref) == [
        f"ATE of the first 200 frames {0.41 * f} m > {f} x the reference's 0.4 m"]
    short = dict(got, frames=300, ate_m_of_first={100: 0.25, 200: 0.5})
    assert kitti_soak.gates(short, ref) == []  # the prefix of 500 is not covered
    lost = dict(short, ate_m_of_first={100: 0.25})  # 200 frames covered, no ATE: fails
    assert kitti_soak.gates(lost, ref)[0].startswith("ATE of the first 200 frames None")
    early = kitti_soak.at_depth(ref, 250)
    assert early["frames"] == 250 and early["keyframes_created"] == 50
    assert kitti_soak.at_depth(ref, 500) is ref
    run = dict(frames=250, tracked=250, keyframes_created=53, landmarks_created=26000,
               loops_closed=0, ate_m_of_first={100: 0.2, 200: 0.35})
    assert kitti_soak.gates(run, early) == ["keyframes_created 53 not within 5% of the "
                                            "reference's 50"]
    # The prefix ATEs read at another depth (before the first loop): the
    # counts at 500, the ATEs at 250.
    bad_ates = dict(got, progress=[dict(early, ate_m_of_first={100: 0.1, 200: 0.31 * f})])
    assert kitti_soak.gates(got, ref, ates_at=(bad_ates["progress"][0], early)) == [
        f"ATE of the first 200 frames {0.31 * f} m > {f} x the reference's 0.3 m"]
    assert kitti_soak.gates(got, ref, ates_at=(early, early)) == []


def test_at_depth_refuses_a_depth_the_record_lacks():
    """A run is held against the reference only where the reference read
    itself: a depth between its readings, or past its end, raises."""
    ref = dict(frames=500, tracked=500, progress=[dict(frame=250, tracked=250)])
    assert kitti_soak.at_depth(ref, 250) == dict(frame=250, tracked=250, frames=250)
    for frames in (240, 600):
        with pytest.raises(ValueError, match=f"no reading at frame {frames}"):
            kitti_soak.at_depth(ref, frames)


@pytest.mark.slow
def test_first_30_frames_in_both_packages(tmp_path, street):
    """30 frames at 1226x370 through the first bend of the circuit, both
    runners at the reference's gates (min_inliers_local 30). Each must track
    every frame within ATE 0.5 m; between them keyframes created within 2
    or 25 %, landmarks created within 15 %, ATEs within 0.05 m (ORB
    descriptors differ on ~20 % of keypoints, so decisions may)."""
    root = str(tmp_path / "kitti")
    kitti_synth.generate(root, n_frames=30, world=street, centred=True, log=lambda *a: None)
    script = _script()
    res = {p: script.main(["--package", p, "--root", root, "--every", "10",
                           "--out", str(tmp_path / f"{p}.txt")]) for p in ("jax", "port")}
    for p, r in res.items():
        assert r["tracked"] == 30 and r["ate_rmse_m"] < 0.5, (p, r)
    j, t = res["jax"], res["port"]
    assert abs(t["keyframes_created"] - j["keyframes_created"]) <= max(
        2, 0.25 * j["keyframes_created"]), (j, t)
    assert abs(t["landmarks_created"] - j["landmarks_created"]) <= 0.15 * j["landmarks_created"]
    assert abs(t["ate_rmse_m"] - j["ate_rmse_m"]) <= 0.05, (j["ate_rmse_m"], t["ate_rmse_m"])
