"""KITTI IO, the zlib PNG codec, the native loader, the KITTI-layout
generator, `rpe` and vocabulary files: the port against the JAX package.

Readers and writers are held bit for bit: the same parsed calibration,
scans, poses and times from both packages on tests/test_kitti_io.py's fake
tree; the port's PNG decoder equal to PIL on gray and RGB images written
with each of the five PNG filter types; the port's native loader equal to
`io/kitti.py`; `kitti_synth.generate` writing byte-identical trees in both
packages. `rpe` within 1e-9.
"""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from sqrtlm_slam_tpu.eval import ate as j_ate
from sqrtlm_slam_tpu.frontend import vocab as j_vocab
from sqrtlm_slam_tpu.io import kitti as j_kitti
from sqrtlm_slam_tpu_torch.eval import ate as t_ate
from sqrtlm_slam_tpu_torch.frontend import vocab as t_vocab
from sqrtlm_slam_tpu_torch.io import kitti as t_kitti
from sqrtlm_slam_tpu_torch.io import native_loader, png
from sqrtlm_slam_tpu_torch.utils import desc_to_numpy


@pytest.fixture()
def fake_kitti(tmp_path):
    """tests/test_kitti_io.py's minimal tree: calib, times, scans, poses."""
    root = tmp_path / "kitti"
    seq = root / "sequences" / "04"
    (seq / "velodyne").mkdir(parents=True)
    (root / "poses").mkdir(parents=True)
    fx, cx, cy, bf = 718.856, 607.1928, 185.2157, 386.1448
    with open(seq / "calib.txt", "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n"
                f"P1: {fx} 0 {cx} {-bf} 0 {fx} {cy} 0 0 0 1 0\n"
                "Tr: 0 -1 0 0 0 0 -1 0 1 0 0 -0.08\n")
    np.savetxt(seq / "times.txt", np.arange(5) * 0.1)
    rng = np.random.RandomState(0)
    for i in range(5):
        rng.randn(100, 4).astype(np.float32).tofile(seq / "velodyne" / f"{i:06d}.bin")
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5) * 1.5
    with open(root / "poses" / "04.txt", "w") as f:
        for T in poses:
            f.write(" ".join(str(x) for x in T[:3].reshape(-1)) + "\n")
    return str(root)


def test_sequence_reads_equal_the_jax_package(fake_kitti):
    js, ts = j_kitti.KittiSequence(fake_kitti, "04"), t_kitti.KittiSequence(fake_kitti, "04")
    assert tuple(ts.calib.cam) == tuple(float(x) for x in js.calib.cam)
    np.testing.assert_array_equal(ts.calib.T_cam_velo, js.calib.T_cam_velo)
    assert ts.num_frames == js.num_frames == 5
    np.testing.assert_array_equal(ts.times, js.times)
    np.testing.assert_array_equal(ts.gt_poses, js.gt_poses)
    for i in range(5):
        np.testing.assert_array_equal(ts.velodyne(i), js.velodyne(i))
        np.testing.assert_array_equal(ts.cloud_in_cam(i), js.cloud_in_cam(i))


def test_pose_writer_round_trip_and_same_text(fake_kitti, tmp_path):
    poses = t_kitti.KittiSequence(fake_kitti, "04").gt_poses
    poses[:, :3] += np.random.RandomState(1).randn(len(poses), 3, 4) * 1e-3
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    t_kitti.write_kitti_poses(str(a), poses)
    j_kitti.write_kitti_poses(str(b), poses)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(t_kitti.read_poses(str(a)), j_kitti.read_poses(str(a)))
    np.testing.assert_allclose(t_kitti.read_poses(str(a)), poses, atol=1e-8)


def test_ate_and_rpe_equal_the_jax_package(fake_kitti):
    gt = t_kitti.KittiSequence(fake_kitti, "04").gt_poses
    rng = np.random.RandomState(2)
    est = gt.copy()
    est[:, :3, 3] += 0.05 + rng.randn(5, 3) * 0.02
    c, s = np.cos(0.01 * np.arange(5)), np.sin(0.01 * np.arange(5))
    est[:, 0, 0], est[:, 0, 2], est[:, 2, 0], est[:, 2, 2] = c, s, -s, c
    for scale in (False, True):
        assert abs(t_ate.ate_rmse(est, gt, align_scale=scale)[0]
                   - j_ate.ate_rmse(est, gt, align_scale=scale)[0]) < 1e-6
    assert t_ate.ate_rmse(gt, gt)[0] < 1e-6
    for delta in (1, 2):
        got, want = t_ate.rpe(est, gt, delta), j_ate.rpe(est, gt, delta)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    t_err, r_err = t_ate.rpe(gt, gt)
    assert t_err < 1e-9 and r_err < 1e-3


# -- PNG codec --------------------------------------------------------------


def _filtered_png(img: np.ndarray, kind: int) -> bytes:
    """A PNG of `img` whose every row uses filter `kind` (0-4), written from
    the specification, independently of the decoder under test."""
    H, W = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    x = img.reshape(H, W * ch).astype(np.int64)
    out = bytearray()
    for y in range(H):
        prior = x[y - 1] if y else np.zeros(W * ch, np.int64)
        cur = x[y]
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(k, body):
        return struct.pack(">I", len(body)) + k + body + struct.pack(">I", zlib.crc32(k + body))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", range(5))
@pytest.mark.parametrize("channels", [1, 3])
def test_png_decoder_equals_pil(kind, channels, tmp_path):
    rng = np.random.RandomState(10 * kind + channels)
    shape = (23, 37) if channels == 1 else (23, 37, 3)
    # Random bytes and a smooth ramp: every branch of the Paeth predictor.
    ramp = np.broadcast_to((np.arange(37) * 7 % 256).reshape((1, 37) + (1,) * (len(shape) - 2)),
                           shape)
    img = np.where(rng.rand(*shape) < 0.5, rng.randint(0, 256, shape), ramp).astype(np.uint8)
    data = _filtered_png(img, kind)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(png.decode(data), want)
    path = tmp_path / "img.png"
    path.write_bytes(data)
    pil_l = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(png.read_gray(str(path)), pil_l)


def test_png_decoder_reads_pil_files_and_pil_reads_the_encoder(tmp_path):
    rng = np.random.RandomState(3)
    for shape in ((40, 64), (40, 64, 3)):
        ramp = np.linspace(0, 190, 64).reshape((1, 64) + (1,) * (len(shape) - 2))
        img = (rng.rand(*shape) * 60 + ramp).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")  # PIL's adaptive filters
        np.testing.assert_array_equal(png.decode(buf.getvalue()), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png.encode(img)))),
                                      img)
    path = str(tmp_path / "g.png")
    png.write(path, img[..., 0])
    np.testing.assert_array_equal(t_kitti.read_image(path), j_kitti.read_image(path))
    with pytest.raises(ValueError):
        png.decode(b"not a png")


def test_read_image_without_pil_uses_the_zlib_decoder(tmp_path, monkeypatch):
    rgb = np.random.RandomState(4).randint(0, 256, (30, 50, 3)).astype(np.uint8)
    path = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(path)
    with_pil = t_kitti.read_image(path)
    np.testing.assert_array_equal(with_pil, j_kitti.read_image(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert t_kitti.image_backend() == "zlib"
    np.testing.assert_array_equal(t_kitti.read_image(path), with_pil)
    from sqrtlm_slam_tpu_torch.eval import kitti_synth

    gray = rgb[..., 1]
    kitti_synth.write_png(str(tmp_path / "w.png"), gray)  # the zlib writer
    monkeypatch.undo()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), gray)


# -- native loader ----------------------------------------------------------


@pytest.fixture(scope="module")
def mini_seq(tmp_path_factory):
    """tests/test_native_loader.py's tree: 4 gray PNGs and scans."""
    root = tmp_path_factory.mktemp("kitti_native_port")
    img_dir, velo_dir = root / "image_0", root / "velodyne"
    img_dir.mkdir()
    velo_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (120, 160)).astype(np.uint8)).save(
            img_dir / f"{i:06d}.png")
        rng.randn(500, 4).astype(np.float32).tofile(velo_dir / f"{i:06d}.bin")
    return str(img_dir), str(velo_dir)


def _native_or_skip():
    if not native_loader.NativeKittiLoader.available():
        pytest.skip(f"no C++ compiler or libpng here: {native_loader.build_error()}")


def test_native_loader_builds_outside_the_source_tree():
    _native_or_skip()
    built = list(native_loader.BUILD_DIR.glob("libkittiloader-*.so"))
    assert built and all(native_loader.ROOT / "build" in p.parents for p in built)


def test_native_loader_decodes_like_io_kitti(mini_seq):
    _native_or_skip()
    img_dir, velo_dir = mini_seq
    ld = native_loader.NativeKittiLoader(img_dir, velo_dir, 4, n_threads=2, window=4)
    ld.prefetch(0)
    for i in range(4):
        img, velo = ld.frame(i)
        np.testing.assert_array_equal(img, t_kitti.read_image(f"{img_dir}/{i:06d}.png"))
        np.testing.assert_array_equal(velo, t_kitti.read_velodyne_bin(f"{velo_dir}/{i:06d}.bin"))
    with pytest.raises(IndexError):
        ld.frame(4)
    ld.close()


def test_native_loader_prefetch_eviction(mini_seq):
    _native_or_skip()
    img_dir, velo_dir = mini_seq
    ld = native_loader.NativeKittiLoader(img_dir, velo_dir, 4, n_threads=2, window=2)
    ld.prefetch(2)  # evicts 0-1; frames 2-3 decode ahead
    img, _ = ld.frame(3)
    np.testing.assert_array_equal(img, t_kitti.read_image(f"{img_dir}/000003.png"))
    img0, _ = ld.frame(0)  # an evicted frame decodes again on the caller
    np.testing.assert_array_equal(img0, t_kitti.read_image(f"{img_dir}/000000.png"))
    ld.close()


# -- generator and vocabulary files ------------------------------------------


def test_kitti_synth_writes_the_jax_packages_tree(tmp_path):
    from sqrtlm_slam_tpu.eval import kitti_synth as j_synth
    from sqrtlm_slam_tpu_torch.eval import kitti_synth as t_synth

    j_synth.generate(str(tmp_path / "jax"), n_frames=2, log=lambda *a: None)
    t_synth.generate(str(tmp_path / "port"), n_frames=2, log=lambda *a: None)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 7  # calib, times, poses, 2 PNGs, 2 scans
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    seq = t_kitti.KittiSequence(str(tmp_path / "port"), "00")
    assert seq.image(0).shape == (370, 1226) and seq.velodyne(1).shape[1] == 4


def test_vocabulary_files_cross_between_the_packages(tmp_path):
    jv = j_vocab.load_default()
    tv = t_vocab.load_default("cpu")
    t_vocab.save(tv, str(tmp_path / "port.npz"))
    j_vocab.save(jv, str(tmp_path / "jax.npz"))
    for path in ("port.npz", "jax.npz"):
        a, b = np.load(tmp_path / path), np.load(tmp_path / "jax.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    back = j_vocab.load(str(tmp_path / "port.npz"))
    again = t_vocab.load(str(tmp_path / "jax.npz"), "cpu")
    assert back.k == jv.k and again.k == tv.k and again.depth == tv.depth
    for c_j, c_t in zip(back.centroids, again.centroids):
        np.testing.assert_array_equal(np.asarray(c_j), desc_to_numpy(c_t))
    np.testing.assert_array_equal(np.asarray(back.idf), again.idf.numpy())
