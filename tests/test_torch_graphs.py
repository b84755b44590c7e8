"""The port's compiled per-frame programs (`utils.cache`: captured CUDA
graphs) on the CPU, against the JAX package's jitted functions.

On the CPU every graphed name runs its eager function (the caller asked for
the CPU), so here:
  * `pad_cloud` equals the JAX package's bit for bit (N below, at and above
    a bucket multiple; D = 3 and 4), on numpy and on tensors;
  * `extract_features_jit(pad_cloud(x))` equals `extract_features(x)` bit
    for bit (the NaN padding is inert), and the JAX package's
    `extract_features_jit(pad_cloud(x))` at tests/test_torch_fusion.py's
    tolerances;
  * `build_frame_jit` / `build_frame_stereo_jit` equal `build_frame` /
    `build_frame_stereo` bit for bit, and the JAX jitted builds as
    tests/test_torch_frontend.py compares them: keypoints exact, descriptors
    within the measured ORB residual (its module docstring), depth and
    information exact;
  * the cache's key: a changed static argument or shape makes a new key,
    the same call the same key; on the CPU nothing is captured or replayed;
  * every graphed function issues, on these inputs, no operation that
    would read the device back on the card (`.item()`, `nonzero`,
    boolean-mask indexing, a linalg error check, a host-to-device copy of
    an array): a CUDA graph cannot capture one.
  * the port reads its vocabulary from its own copy of the asset.

The same functions captured and replayed on the card:
tests/test_torch_graphs_cuda.py.
"""

import hashlib
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sqrtlm_slam_tpu.eval import synthetic as j_synth
from sqrtlm_slam_tpu.frontend import orb as j_orb
from sqrtlm_slam_tpu.lidar import features as j_feat
from sqrtlm_slam_tpu.pipeline import frame as j_frame
from sqrtlm_slam_tpu_torch import convert, utils
from sqrtlm_slam_tpu_torch.eval import planeworld as t_planeworld
from sqrtlm_slam_tpu_torch.eval import synthetic as t_synth
from sqrtlm_slam_tpu_torch.frontend import vocab as t_vocab
from sqrtlm_slam_tpu_torch.lidar import features as t_feat
from sqrtlm_slam_tpu_torch.lidar import odometry as t_odo
from sqrtlm_slam_tpu_torch.optim import schur_bucketed
from sqrtlm_slam_tpu_torch.pipeline import frame as t_frame
from sqrtlm_slam_tpu_torch.pipeline import local_mapping, tracking
from sqrtlm_slam_tpu_torch.utils import cache, desc_to_numpy

CFG = j_orb.ORBConfig(max_features=600)
SMALL_CFG = dict(num_rings=16, horizon_res_deg=1.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ----------------------------------------------------------------------
# pad_cloud + extract_features_jit
# ----------------------------------------------------------------------


@pytest.mark.parametrize("D", [3, 4])
@pytest.mark.parametrize("n", [1000, 16383, 16384, 16385, 32768 + 7])
def test_pad_cloud_equals_jax(n, D):
    rng = np.random.RandomState(n + D)
    pts = rng.uniform(-50, 50, (n, D)).astype(np.float64)  # float32 comes out
    want = np.asarray(j_feat.pad_cloud(pts))
    got = t_feat.pad_cloud(pts)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 == want.dtype
    assert got.shape == want.shape and got.shape[0] % 16384 == 0
    np.testing.assert_array_equal(got, want)  # NaN rows in the same places
    on_tensor = t_feat.pad_cloud(torch.as_tensor(pts))
    assert on_tensor.dtype == torch.float32
    np.testing.assert_array_equal(on_tensor.numpy(), want)


@pytest.fixture(scope="module")
def scan():
    """tests/test_torch_fusion.py's scan: 16 x 360 rays of the small street
    at the 1-degree column centres, with a few NaN rows."""
    world = t_planeworld.street_circuit_world(seed=0, A=12.0, B=8.0, half_width=4.0,
                                              texel=0.05, panel_spacing=6.0)
    poses, _ = t_planeworld.circuit_trajectory(30, A=12.0, B=8.0, corner_r=3.0, step=0.5)
    raw = world.lidar_scan(poses[3], t_planeworld.T_CAM_VELO, n_rings=16, n_azimuth=360,
                           noise_seed=3)
    pts, _ = t_planeworld.center_scan_on_columns(raw, t_planeworld.T_CAM_VELO, 1.0)
    return np.concatenate([pts, np.full((7, 3), np.nan, np.float32)])


def test_extract_features_jit_padded_equals_unpadded_and_jax(scan):
    cfg_t = t_feat.LidarConfig(**SMALL_CFG)
    cfg_j = j_feat.LidarConfig(**SMALL_CFG)
    padded = t_feat.pad_cloud(scan)
    assert padded.shape[0] == 16384 > scan.shape[0]
    f_pad = t_feat.extract_features_jit(T(padded), cfg_t)
    f_raw = t_feat.extract_features(T(scan), cfg_t)
    for name, a, b in zip(f_raw._fields, f_pad, f_raw):
        assert torch.equal(a, b), name
    assert int(f_pad.sharp_valid.sum()) > 5 and int(f_pad.flat_valid.sum()) > 50
    # Against the JAX package's jitted extraction of the same padded cloud
    # (tests/test_torch_fusion.py::_assert_features_equal's tolerances).
    f_j = j_feat.extract_features_jit(j_feat.pad_cloud(scan), cfg_j)
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        v_j = np.asarray(getattr(f_j, name + "_valid"))
        np.testing.assert_array_equal(getattr(f_pad, name + "_valid").numpy(), v_j)
        np.testing.assert_array_equal(getattr(f_pad, name).numpy()[v_j],
                                      np.asarray(getattr(f_j, name))[v_j], err_msg=name)
    v = np.asarray(f_j.flat_valid)
    np.testing.assert_allclose(f_pad.flat_normal.numpy()[v], np.asarray(f_j.flat_normal)[v],
                               atol=1e-3)
    np.testing.assert_allclose(f_pad.flat_d.numpy()[v], np.asarray(f_j.flat_d)[v], rtol=1e-3,
                               atol=1e-3)


def test_fusion_frame_with_a_padded_cloud_equals_the_unpadded_one(scan):
    """`build_frame` from a padded cloud (what `track_fusion` now builds):
    the projected depth and the LiDAR features are those of the raw cloud."""
    world = t_synth.SyntheticWorld(seed=3, n_points=900)
    img, _ = world.render(t_synth.forward_trajectory(2, step=0.4)[0], t_synth.DEFAULT_CAM)
    orb_cfg = convert.orb_config(CFG)
    R = torch.as_tensor(t_planeworld.T_CAM_VELO[:3, :3], dtype=torch.float32)
    t = torch.as_tensor(t_planeworld.T_CAM_VELO[:3, 3], dtype=torch.float32)
    kw = dict(T_cam_lidar=(R, t), lidar_cfg=t_feat.LidarConfig(**SMALL_CFG))
    a = t_frame.build_frame_jit(T(img), t_synth.DEFAULT_CAM, orb_cfg,
                                cloud_lidar=T(t_feat.pad_cloud(scan)), **kw)
    b = t_frame.build_frame(T(img), t_synth.DEFAULT_CAM, orb_cfg, cloud_lidar=T(scan), **kw)
    for x, y in zip(a.lidar + (a.uvr, a.depth), b.lidar + (b.uvr, b.depth)):
        assert torch.equal(x, y)


# ----------------------------------------------------------------------
# build_frame_jit / build_frame_stereo_jit
# ----------------------------------------------------------------------


WIDE = j_synth.DEFAULT_CAM._replace(bf=220.0)  # tests/test_torch_stereo.py's pair


@pytest.fixture(scope="module")
def images():
    """tests/test_torch_frontend.py's RGB-D frame and tests/test_torch_stereo.py's
    rectified pair (the right camera moved by the baseline along x)."""
    world = j_synth.SyntheticWorld(seed=3, n_points=900)
    img, depth = world.render(j_synth.forward_trajectory(25, step=0.4)[12], j_synth.DEFAULT_CAM)
    world_s = j_synth.SyntheticWorld(seed=4, n_points=900)
    T_l = j_synth.forward_trajectory(1)[0]
    left = world_s.render(T_l, WIDE)[0]
    T_r = type(T_l)(T_l.R, T_l.t - jnp.array([WIDE.bf / WIDE.fx, 0.0, 0.0]))
    right = world_s.render(T_r, WIDE)[0]
    return tuple(np.asarray(a) for a in (img, depth, left, right))


def _assert_keypoints_match_jax(kt, kj):
    """tests/test_torch_frontend.py's bounds: keypoints exact, descriptors
    within the measured residual of the pyramid's float32 summation order."""
    valid = np.asarray(kj.valid)
    np.testing.assert_array_equal(kt.valid.numpy(), valid)
    np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
    np.testing.assert_array_equal(kt.octave.numpy(), np.asarray(kj.octave))
    x = np.asarray(kj.desc) ^ desc_to_numpy(kt.desc)
    bits = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)[valid]
    lvl0 = np.asarray(kj.octave)[valid] == 0
    assert (bits[lvl0] == 0).mean() >= 0.98 and bits[lvl0].max() <= 2
    assert (bits == 0).mean() >= 0.7
    assert bits.mean() <= 1.5 and bits.max() <= 32


def test_build_frame_jit_equals_build_frame_and_the_jax_build(images):
    img, depth, _, _ = images
    cam, orb_cfg = convert.camera(j_synth.DEFAULT_CAM), convert.orb_config(CFG)
    before = (utils.graph_captures, utils.graph_replays)
    ft = t_frame.build_frame_jit(T(img), cam, orb_cfg, depth_img=T(depth))
    fe = t_frame.build_frame(T(img), cam, orb_cfg, depth_img=T(depth))
    assert (utils.graph_captures, utils.graph_replays) == before  # the CPU runs eagerly
    assert t_frame.build_frame_jit.num_entries() == 0
    for a, b in zip(ft.kp + (ft.uvr, ft.depth, ft.inv_sigma2),
                    fe.kp + (fe.uvr, fe.depth, fe.inv_sigma2)):
        assert torch.equal(a, b)
    fj = j_frame.build_frame_jit(jnp.asarray(img), j_synth.DEFAULT_CAM, CFG,
                                 depth_img=jnp.asarray(depth))
    _assert_keypoints_match_jax(ft.kp, fj.kp)
    np.testing.assert_array_equal(ft.depth.numpy(), np.asarray(fj.depth))
    np.testing.assert_allclose(ft.uvr.numpy(), np.asarray(fj.uvr), atol=1e-4)
    np.testing.assert_array_equal(ft.inv_sigma2.numpy(), np.asarray(fj.inv_sigma2))


def test_build_frame_stereo_jit_equals_build_frame_stereo_and_the_jax_build(images):
    _, _, left, right = images
    cam, orb_cfg = convert.camera(WIDE), convert.orb_config(CFG)
    ft = t_frame.build_frame_stereo_jit(T(left), T(right), cam, orb_cfg)
    fe = t_frame.build_frame_stereo(T(left), T(right), cam, orb_cfg)
    for a, b in zip(ft.kp + (ft.uvr, ft.depth, ft.inv_sigma2),
                    fe.kp + (fe.uvr, fe.depth, fe.inv_sigma2)):
        assert torch.equal(a, b)
    assert int((ft.depth > 0).sum()) > 50
    fj = j_frame.build_frame_stereo_jit(jnp.asarray(left), jnp.asarray(right), WIDE, CFG)
    _assert_keypoints_match_jax(ft.kp, fj.kp)
    np.testing.assert_array_equal(ft.inv_sigma2.numpy(), np.asarray(fj.inv_sigma2))


# ----------------------------------------------------------------------
# The cache's key
# ----------------------------------------------------------------------


def test_cache_key_follows_statics_shapes_and_nesting():
    cam, orb_cfg = t_synth.DEFAULT_CAM, convert.orb_config(CFG)
    key = t_frame.build_frame_jit.key
    img, depth = torch.zeros(240, 320), torch.zeros(240, 320)
    k0 = key(img, cam, orb_cfg, depth_img=depth)
    # The same call, other values of the same shapes: the same entry.
    assert key(img + 1, cam, orb_cfg, depth_img=depth + 2) == k0
    assert key(img, cam=cam, orb_cfg=orb_cfg, depth_img=depth) == k0
    # A changed static argument, shape, dtype or nesting: a new entry.
    assert key(img, cam, orb_cfg._replace(max_features=500), depth_img=depth) != k0
    assert key(img, cam._replace(fx=cam.fx + 1), orb_cfg, depth_img=depth) != k0
    assert key(torch.zeros(240, 321), cam, orb_cfg, depth_img=torch.zeros(240, 321)) != k0
    assert key(img.double(), cam, orb_cfg, depth_img=depth) != k0
    assert key(img, cam, orb_cfg) != k0  # monocular: no depth image
    lcfg = t_feat.LidarConfig()
    kf = key(img, cam, orb_cfg, cloud_lidar=torch.zeros(16384, 3), lidar_cfg=lcfg)
    assert key(img, cam, orb_cfg, cloud_lidar=torch.ones(16384, 3), lidar_cfg=lcfg) == kf
    assert key(img, cam, orb_cfg, cloud_lidar=torch.zeros(32768, 3), lidar_cfg=lcfg) != kf
    assert key(img, cam, orb_cfg, cloud_lidar=torch.zeros(16384, 3),
               lidar_cfg=lcfg._replace(num_rings=32)) != kf
    # Values that are neither tensors nor hashable, and tensors in static
    # arguments, are refused.
    with pytest.raises(TypeError):
        key(img, cam, orb_cfg, cloud_lidar=torch.zeros(16384, 3),
            T_cam_lidar=(np.eye(3), np.zeros(3)), lidar_cfg=lcfg)
    g = cache.graphed(lambda x, scale: x * scale, static_argnames=("scale",))
    with pytest.raises(TypeError):
        g.key(img, torch.ones(1))
    assert g.key(img, 2.0) != g.key(img, 3.0)


def test_graphed_calls_run_eagerly_on_the_cpu_and_count_nothing():
    calls = []

    def f(x, y, k: int):
        calls.append(k)
        return {"sum": x + y, "k": k, "pair": (x * k, None)}

    g = cache.graphed(f, static_argnames=("k",))
    before = (utils.graph_captures, utils.graph_replays)
    x, y = torch.arange(4.0), torch.ones(4)
    out = g(x, y, 3)
    assert calls == [3] and out["k"] == 3 and out["pair"][1] is None
    assert torch.equal(out["sum"], x + y) and torch.equal(out["pair"][0], x * 3)
    with cache.disable_graphs():
        g(x, y, k=4)
    assert calls == [3, 4]
    assert g.num_entries() == 0 and (utils.graph_captures, utils.graph_replays) == before
    assert g.eager is f and g.__name__ == "f"


counter = 0


def test_count_launch_adds_one_outside_a_capture():
    global counter
    counter = 0
    cache.count_launch(__name__, "counter")
    cache.count_launch(__name__, "counter")
    assert counter == 2


# ----------------------------------------------------------------------
# No operation that reads the device back (a CUDA graph cannot hold one)
# ----------------------------------------------------------------------

# Operations that wait for the device or copy host data to it on the card.
_READS_THE_DEVICE = {
    "aten._local_scalar_dense.default", "aten.nonzero.default", "aten._unique2.default",
    "aten.unique_dim.default", "aten.unique_consecutive.default",
    "aten.masked_select.default", "aten._linalg_check_errors.default",
    "aten.repeat_interleave.Tensor", "aten.bincount.default", "aten.equal.default",
    "aten.is_nonzero.default",
}


class _DeviceReads(TorchDispatchMode):
    """Records the operations of `_READS_THE_DEVICE`, boolean-mask indexing
    (a `nonzero` inside), and tensors made from host data of more than one
    element (a host-to-device copy on the card; one-element tensors made for
    a slice assignment become a fill there), with the port's line issuing
    each."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        out = func(*args, **(kwargs or {}))
        bad = name in _READS_THE_DEVICE
        if name.startswith(("aten.index.Tensor", "aten.index_put", "aten._index_put_impl")):
            bad = any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                      for i in args[1])
        if name == "aten.lift_fresh.default":
            bad = args[0].numel() > 1
        if bad:
            where = [f"{f.filename.split('sqrtlm_slam_tpu_torch')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack() if "sqrtlm_slam_tpu_torch" in f.filename]
            self.found.append((name, where[-1:]))
        return out


def _lidar_frame_and_map(scan):
    cfg = t_feat.LidarConfig(**SMALL_CFG)
    feat = t_feat.extract_features(T(scan), cfg)
    rng = np.random.RandomState(0)
    pts = T(rng.uniform(-10, 10, (512, 3)).astype(np.float32))
    nrm = torch.nn.functional.normalize(T(rng.normal(size=(512, 3)).astype(np.float32)), dim=-1)
    ok = torch.ones(512, dtype=torch.bool)
    return feat, t_odo.build_local_map(pts, ok, pts.flip(0), ok, nrm, t_odo.OdomConfig())


def _step_inputs(images, scan):
    """A local map from one frame's depth keypoints (slightly moved) and a
    second frame to track against it, with LiDAR features and a LiDAR map."""
    img, depth, _, _ = images
    cam, orb_cfg = t_synth.DEFAULT_CAM, convert.orb_config(CFG)
    f0 = t_frame.build_frame(T(img), cam, orb_cfg, depth_img=T(depth))
    ok = (f0.depth > 0) & f0.kp.valid
    z = f0.depth
    pos = torch.stack([(f0.kp.xy[:, 0] - cam.cx) * z / cam.fx,
                       (f0.kp.xy[:, 1] - cam.cy) * z / cam.fy, z], -1) + 0.01
    lm = tracking.LocalMapBuffer(ids=np.arange(len(z)), pos=pos, desc=f0.kp.desc, valid=ok,
                                 max_dist=torch.full_like(z, float("inf")))
    feat, lidar_map = _lidar_frame_and_map(scan)
    frame = f0._replace(lidar=feat)
    pose = tracking.se3.identity()
    return pose, torch.zeros(6), lm._replace(ids=None), frame, lidar_map


def _graphed_calls(images, scan):
    """(name, graphed function, args, kwargs) of every captured program."""
    img, depth, left, right = images
    cam, orb_cfg = t_synth.DEFAULT_CAM, convert.orb_config(CFG)
    lcfg = t_feat.LidarConfig(**SMALL_CFG)
    R, t = torch.eye(3), torch.zeros(3)
    pose, vel, lm, frame, lidar_map = _step_inputs(images, scan)
    frame_a = frame._replace(lidar=None)
    pose_a, _, _, n_a = tracking._stage_a(pose, vel, lm, frame_a, cam, 15.0)
    flat, _ = t_synth.make_ba_problem(seed=1, P=8, L=256, stereo_frac=0.6, obs_per_landmark=4)
    problem = schur_bucketed.from_flat(flat, 8, device="cpu")
    return [
        ("build_frame_rgbd", t_frame.build_frame_jit, (T(img), cam, orb_cfg),
         dict(depth_img=T(depth))),
        ("build_frame_mono", t_frame.build_frame_jit, (T(img), cam, orb_cfg), {}),
        ("build_frame_fusion", t_frame.build_frame_jit, (T(img), cam, orb_cfg),
         dict(cloud_lidar=T(t_feat.pad_cloud(scan)), T_cam_lidar=(R, t), lidar_cfg=lcfg)),
        ("build_frame_stereo", t_frame.build_frame_stereo_jit,
         (T(left), T(right), convert.camera(WIDE), orb_cfg), {}),
        ("extract_features", t_feat.extract_features_jit, (T(t_feat.pad_cloud(scan)), lcfg), {}),
        ("stage_a", tracking._stage_a_jit, (pose, vel, lm, frame_a, cam, 15.0), {}),
        ("stages_bc", tracking._stages_bc_jit,
         (pose, pose_a, n_a, lm, frame._replace(lidar=None), cam, 7.0, 40.0), {}),
        ("stages_bc_fused", tracking._stages_bc_jit,
         (pose, pose_a, n_a, lm, frame, cam, 7.0, 40.0, lidar_map), {}),
        ("local_ba", local_mapping._bucketed_local_ba_jit, (problem, cam), {}),
    ]


@pytest.fixture(scope="module")
def graphed_calls(images, scan):
    return _graphed_calls(images, scan)


@pytest.mark.parametrize("which", range(9))
def test_graphed_functions_issue_no_device_read(graphed_calls, which):
    name, fn, args, kwargs = graphed_calls[which]
    fn(*args, **kwargs)  # first use: the per-device tables a warm-up would make
    mode = _DeviceReads()
    with mode:
        fn(*args, **kwargs)
    assert not mode.found, (name, mode.found)


def test_the_step_through_its_stages_equals_the_old_single_function(images, scan):
    """`track_frame_step` (stage A, the retry read, stages B and C) gives
    what the same stages give called in one piece, fused and not."""
    pose, vel, lm, frame, lidar_map = _step_inputs(images, scan)
    cam = t_synth.DEFAULT_CAM
    for lmap, fr in ((None, frame._replace(lidar=None)), (lidar_map, frame)):
        for min_inl in (0, 10**6):  # without and with the widened retry
            got = tracking.track_frame_step(pose, vel, lm, fr, cam, 15.0, 7.0, min_inl, 40.0,
                                            lidar_map=lmap)
            outA = tracking._stage_a(pose, vel, lm, fr, cam, 15.0 if min_inl == 0 else 30.0)
            want = tracking._stages_bc(pose, outA[0], outA[3], lm, fr, cam, 7.0, 40.0,
                                       lidar_map=lmap)
            for a, b in zip(got[2:], want[2:]):
                assert torch.equal(a, b)
            assert torch.equal(got[0].R, want[0].R) and torch.equal(got[1], want[1])


def test_the_port_reads_its_own_vocabulary_asset():
    """The runtime reads the port's copy; it is the JAX package's file byte
    for byte."""
    port = t_vocab.DEFAULT_ASSET
    assert port.parent.parent.name == "sqrtlm_slam_tpu_torch"
    jax_file = port.parents[2] / "sqrtlm_slam_tpu" / "assets" / port.name
    digest = [hashlib.sha256(p.read_bytes()).hexdigest() for p in (port, jax_file)]
    assert digest[0] == digest[1] and port.stat().st_size == 298420
    assert t_vocab.load_default("cpu").num_words == 10000


def test_the_lidar_local_map_keeps_one_shape_across_keyframes(images, scan):
    """The fused stages' LiDAR map (`aggregate_kf_lidar` over the slots of
    `lidar_map_kfs + 1` keyframes, downsampled to `map_capacity`) has one
    shape whatever the number of keyframes and points: one graph serves
    every keyframe."""
    from sqrtlm_slam_tpu_torch.mapstore import MapStore

    store = MapStore(max_keyframes=16, max_landmarks=64, feats_per_kf=8)
    rng = np.random.RandomState(1)
    for k, n in enumerate((40, 300, 512, 90, 200, 7)):
        store.kf_R[k] = np.eye(3, dtype=np.float32)
        pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        nrm = np.tile(np.array([0, 0, 1], np.float32), (2 * n, 1))
        store.set_kf_lidar(k, pts, np.ones(n, bool),
                           np.concatenate([pts, pts + 0.5]), nrm, np.ones(2 * n, bool))
    n_slots = tracking.TrackingConfig().lidar_map_kfs + 1
    pose, _, lm, frame, _ = _step_inputs(images, scan)
    cam = t_synth.DEFAULT_CAM
    keys = []
    for kfs in ([0], [0, 1, 2], list(range(6))):
        lmap = tracking.local_map_from_clouds(tracking.aggregate_kf_lidar(store, kfs, n_slots),
                                              "cpu")
        keys.append(tracking._stages_bc_jit.key(pose, pose, torch.tensor(50), lm, frame, cam,
                                                7.0, 40.0, lmap))
    assert keys[0] == keys[1] == keys[2]
