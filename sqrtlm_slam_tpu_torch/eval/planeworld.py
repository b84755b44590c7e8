"""Textured-surface world renderer (perspective-correct) and HDL-64-pattern
LiDAR scanner, in numpy, for KITTI-layout synthetic sequences.

Counterpart of `sqrtlm_slam_tpu/eval/planeworld.py` without JAX (a test
holds `render` and `lidar_scan` bit-identical to it): a street-corridor
world of finite textured planes rendered by ray casting, with

  * a true perspective warp, so a wall seen at a slant foreshortens like a
    real facade and ORB descriptors deform across frames the way the
    matcher's scale / rotation model expects;
  * mip-mapped trilinear texture sampling (stable appearance under
    minification);
  * multi-octave value-noise textures with a posterized mid band and
    rectangle structure: corners at every pyramid level, discriminative
    BRIEF bits, no self-similar lattice;
  * a LiDAR scan against the same geometry (64 elevation rings over
    +2 .. -24.8 degrees), so the ring / range-image / curvature stages of
    the fusion path see realistic structure.

`render` returns numpy float32 arrays and `circuit_trajectory` the port's
`synthetic.Pose`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from .synthetic import Pose



class Plane(NamedTuple):
    p0: np.ndarray        # (3,) corner
    e1: np.ndarray        # (3,) full edge vector (texture u axis)
    e2: np.ndarray        # (3,) full edge vector (texture v axis)
    n: np.ndarray         # (3,) unit normal
    mips: tuple           # mip chain, mips[0] = (n1, n2) float32 highest res
    texel: float          # world metres per level-0 texel


# -- texture synthesis ------------------------------------------------------

def _upsample_grid(g: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """Bilinear upsample a (g1, g2) grid to (n1, n2)."""
    y = np.linspace(0, g.shape[0] - 1, n1)
    x = np.linspace(0, g.shape[1] - 1, n2)
    i0 = np.floor(y).astype(np.int32)
    i1 = np.minimum(i0 + 1, g.shape[0] - 1)
    fy = (y - i0).astype(np.float32)
    j0 = np.floor(x).astype(np.int32)
    j1 = np.minimum(j0 + 1, g.shape[1] - 1)
    fx = (x - j0).astype(np.float32)
    rows = g[i0] * (1 - fy)[:, None] + g[i1] * fy[:, None]
    return rows[:, j0] * (1 - fx)[None, :] + rows[:, j1] * fx[None, :]


def make_texture(
    rng: np.random.RandomState, len1: float, len2: float, texel: float = 0.015
) -> tuple:
    """Multi-octave world-scale texture for a len1 x len2 (m) rectangle.

    Octaves are defined by world wavelength (16 m .. 0.25 m) so texture
    statistics are consistent across planes of different sizes. The >=1 m
    band is posterized into flat regions with sharp boundaries (corner
    features at coarse pyramid levels); sub-metre octaves stay continuous
    (BRIEF discriminativeness). Returns (mip_chain, texel)."""
    n1 = int(np.clip(round(len1 / texel), 48, 12288))
    n2 = int(np.clip(round(len2 / texel), 48, 12288))
    t1 = len1 / n1  # realized texel (may differ from request due to clamp)

    def band(waves_amps):
        out = np.zeros((n1, n2), np.float32)
        for wav, amp in waves_amps:
            g1 = max(int(round(len1 / wav)), 1) + 1
            g2 = max(int(round(len2 / wav)), 1) + 1
            if g1 > n1 or g2 > n2:
                continue
            out += _upsample_grid(
                rng.rand(g1, g2).astype(np.float32) - 0.5, n1, n2
            ) * amp
        return out

    def posterize(x, levels):
        if np.ptp(x) <= 1e-6:
            return x
        q = (x - x.min()) / np.ptp(x)
        return np.floor(q * levels) / (levels - 1.0) - 0.5

    # Three bands: posterized coarse blobs (corners at high pyramid
    # levels / long range), posterized mid blobs (the FAST workhorse at
    # 5-40 m viewing), continuous fine detail (BRIEF discriminativeness
    # and close-range corners).
    coarse = posterize(
        band([(16.0, 1.0), (8.0, 0.7), (4.0, 0.5), (2.0, 0.35)]), 6.0
    )
    mid = posterize(band([(1.0, 0.55), (0.5, 0.45)]), 5.0)
    fine = band([(0.25, 0.5), (0.12, 0.4)])
    # Micro band: structure the 2-10 px scale at CLOSE range (2-7 m).
    # During corners the near wall fills the FOV magnified well past the
    # 12 cm band — without centimetre-scale detail it renders as smooth
    # blobs, FAST starves, and tracking decayed to LOST through every turn
    # in an earlier soak run. Real surfaces carry detail at all scales.
    micro = 0.6 * posterize(band([(0.06, 0.5)]), 4.0) + band([(0.03, 0.35)])
    tex = 0.42 * coarse + 0.38 * mid + 0.34 * fine + 0.30 * micro

    # Structural features: window/door/sign-like rectangles with sharp
    # borders at random positions, sizes and intensities. Value noise alone
    # is STATISTICALLY SELF-SIMILAR at BRIEF scale (~0.1-0.25 m lattice):
    # projection-window matching on it lattice-slips — neighbouring
    # look-alike corners one noise period over match consistently, and the
    # pose LM confirms an under-rotated pose through every turn (measured:
    # rotation error grows ~2 deg/frame mid-corner with 200+ 'inliers').
    # Real facades carry aperiodic man-made structure; these rectangles are
    # that structure and break the lattice degeneracy.
    area = len1 * len2
    n_rect = int(np.clip(area / 5.0, 6, 4000))
    for _ in range(n_rect):
        rh = max(int(rng.uniform(0.35, 1.8) / max(t1, 1e-6)), 2)
        rw = max(int(rng.uniform(0.35, 1.8) / max(t1, 1e-6)), 2)
        if rh >= n1 or rw >= n2:
            continue
        i0 = rng.randint(0, n1 - rh)
        j0 = rng.randint(0, n2 - rw)
        amp = rng.choice([-1.0, 1.0]) * rng.uniform(0.35, 0.7)
        tex[i0 : i0 + rh, j0 : j0 + rw] = (
            0.35 * tex[i0 : i0 + rh, j0 : j0 + rw] + amp
        )
        # 1-texel darker frame (window reveal / sign border).
        tex[i0, j0 : j0 + rw] -= 0.3
        tex[i0 + rh - 1, j0 : j0 + rw] -= 0.3
        tex[i0 : i0 + rh, j0] -= 0.3
        tex[i0 : i0 + rh, j0 + rw - 1] -= 0.3

    # Contrast stretch to [28, 226] (FAST threshold 20 needs local contrast).
    lo, hi = np.percentile(tex, [1.0, 99.0])
    tex = np.clip((tex - lo) / max(hi - lo, 1e-6), 0.0, 1.0) * 198.0 + 28.0

    mips = [tex.astype(np.float32)]
    m = mips[0]
    while min(m.shape) >= 64:
        h2, w2 = m.shape[0] // 2 * 2, m.shape[1] // 2 * 2
        m = m[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
        mips.append(m.astype(np.float32))
    return tuple(mips), float(t1)


def _make_plane(rng, p0, e1, e2, texel=0.015) -> Plane:
    p0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    n = np.cross(e1, e2)
    n = n / np.linalg.norm(n)
    mips, t = make_texture(
        rng, float(np.linalg.norm(e1)), float(np.linalg.norm(e2)), texel
    )
    return Plane(p0=p0, e1=e1, e2=e2, n=n, mips=mips, texel=t)


def _sample_trilinear(plane: Plane, a, b, lod):
    """Sample the plane's mip chain at normalized coords (a, b) with
    per-sample fractional level-of-detail `lod` (log2 texels-per-pixel)."""
    nlev = len(plane.mips)
    l = np.clip(lod, 0.0, nlev - 1.0)
    l0 = np.floor(l).astype(np.int32)
    l1 = np.minimum(l0 + 1, nlev - 1)
    fl = (l - l0).astype(np.float32)
    out = np.zeros(a.shape, np.float32)

    def bilinear(lev, sel):
        tex = plane.mips[lev]
        x = a[sel] * (tex.shape[0] - 1)
        y = b[sel] * (tex.shape[1] - 1)
        i0 = np.floor(x).astype(np.int32)
        j0 = np.floor(y).astype(np.int32)
        i1 = np.minimum(i0 + 1, tex.shape[0] - 1)
        j1 = np.minimum(j0 + 1, tex.shape[1] - 1)
        fx = (x - i0).astype(np.float32)
        fy = (y - j0).astype(np.float32)
        return (
            tex[i0, j0] * (1 - fx) * (1 - fy)
            + tex[i1, j0] * fx * (1 - fy)
            + tex[i0, j1] * (1 - fx) * fy
            + tex[i1, j1] * fx * fy
        )

    for lev in np.unique(np.concatenate([l0, l1])):
        lev = int(lev)
        w0 = (l0 == lev)
        w1 = (l1 == lev) & (l1 != l0)
        if w0.any():
            out[w0] += bilinear(lev, w0) * (1 - fl[w0])
        if w1.any():
            out[w1] += bilinear(lev, w1) * fl[w1]
        # when l0 == l1 == lev, weight (1-fl)+fl would double-count; the
        # masks above give (1-fl) only, so add the missing fl part:
        w2 = (l0 == lev) & (l1 == lev)
        if w2.any():
            out[w2] += bilinear(lev, w2) * fl[w2]
    return out


class PlaneWorld:
    """Finite textured rectangles rendered by per-pixel ray casting."""

    def __init__(self, planes: List[Plane], background: float = 16.0):
        self.planes = planes
        self.background = background

    # -- camera render ------------------------------------------------------

    def render(
        self,
        T_cw: Pose,
        cam,
        H: int = 370,
        W: int = 1226,
        noise_sigma: float = 1.5,
        noise_seed: Optional[int] = None,
    ):
        """Render (image, depth) at pose T_cw. Depth is the camera-z of the
        nearest surface per pixel (0 where no surface)."""
        R = np.asarray(T_cw.R, np.float64)
        t = np.asarray(T_cw.t, np.float64)
        o = -R.T @ t  # camera centre in world
        vs, us = np.mgrid[0:H, 0:W]
        d_cam = np.stack(
            [
                (us.reshape(-1) - cam.cx) / cam.fx,
                (vs.reshape(-1) - cam.cy) / cam.fy,
                np.ones(H * W),
            ],
            axis=-1,
        )  # z = 1 -> ray parameter == camera depth
        d_w = d_cam @ R  # rows: R^T d

        best_t, best_id, best_a, best_b, best_ct = self._cast(o, d_w)

        img = np.full(H * W, self.background, np.float32)
        depth = np.zeros(H * W, np.float32)
        hit = best_id >= 0
        depth[hit] = best_t[hit].astype(np.float32)
        for i, pl in enumerate(self.planes):
            sel = best_id == i
            if not sel.any():
                continue
            # texels per pixel ~ (z / fx) / (texel * cos(incidence)).
            foot = best_t[sel] / cam.fx
            tpp = foot / (pl.texel * np.maximum(best_ct[sel], 0.18))
            lod = np.log2(np.maximum(tpp, 1.0)).astype(np.float32)
            img[sel] = _sample_trilinear(pl, best_a[sel], best_b[sel], lod)
        if noise_sigma > 0:
            nrng = np.random.RandomState(
                0 if noise_seed is None else noise_seed
            )
            img = img + nrng.randn(H * W).astype(np.float32) * noise_sigma
        img = np.clip(img, 0, 255)
        return img.reshape(H, W), depth.reshape(H, W)

    def _cast(self, o: np.ndarray, d_w: np.ndarray, t_min: float = 0.25):
        """Nearest intersection of rays (o + t*d) with every plane.

        Returns (t, plane_id, a, b, |cos incidence|) per ray; plane_id=-1
        where nothing is hit. `t` is in units of |d| (callers pass either
        unit vectors -> range, or cam-z=1 vectors -> depth)."""
        N = d_w.shape[0]
        best_t = np.full(N, np.inf)
        best_id = np.full(N, -1, np.int32)
        best_a = np.zeros(N, np.float32)
        best_b = np.zeros(N, np.float32)
        best_ct = np.zeros(N, np.float32)
        dn = np.linalg.norm(d_w, axis=-1)
        for i, pl in enumerate(self.planes):
            denom = d_w @ pl.n
            safe = np.abs(denom) > 1e-9
            tt = np.where(
                safe, ((pl.p0 - o) @ pl.n) / np.where(safe, denom, 1.0), -1.0
            )
            x = o[None, :] + tt[:, None] * d_w
            rel = x - pl.p0
            a = (rel @ pl.e1) / float(pl.e1 @ pl.e1)
            b = (rel @ pl.e2) / float(pl.e2 @ pl.e2)
            valid = (
                safe
                & (tt > t_min)
                & (tt < best_t)
                & (a >= 0.0) & (a <= 1.0)
                & (b >= 0.0) & (b <= 1.0)
            )
            best_t = np.where(valid, tt, best_t)
            best_id = np.where(valid, i, best_id)
            best_a = np.where(valid, a, best_a).astype(np.float32)
            best_b = np.where(valid, b, best_b).astype(np.float32)
            best_ct = np.where(
                valid, np.abs(denom) / np.maximum(dn, 1e-9), best_ct
            ).astype(np.float32)
        return best_t, best_id, best_a, best_b, best_ct

    # -- synthetic LiDAR ----------------------------------------------------

    def lidar_scan(
        self,
        T_cw: Pose,
        T_cam_velo: np.ndarray,
        n_rings: int = 64,
        n_azimuth: int = 1440,
        max_range: float = 80.0,
        min_range: float = 1.8,
        noise_sigma: float = 0.012,
        noise_seed: Optional[int] = None,
    ) -> np.ndarray:
        """HDL-64-pattern scan: (N, 4) float32 x,y,z,intensity in the
        VELODYNE frame (x forward, y left, z up), elevation +2..-24.8 deg
        over `n_rings` (the ring structure that the virtual-ring
        assignment of `lidar.features.ring_and_azimuth` reconstructs)."""
        R = np.asarray(T_cw.R, np.float64)
        t = np.asarray(T_cw.t, np.float64)
        R_cv = np.asarray(T_cam_velo[:3, :3], np.float64)
        t_cv = np.asarray(T_cam_velo[:3, 3], np.float64)
        o = R.T @ (t_cv - t)  # velodyne origin in world

        elev = np.deg2rad(np.linspace(2.0, -24.8, n_rings))
        azim = np.arange(n_azimuth) * (2 * np.pi / n_azimuth)
        ce, se_ = np.cos(elev), np.sin(elev)
        ca, sa = np.cos(azim), np.sin(azim)
        d_v = np.stack(
            [
                (ce[:, None] * ca[None, :]).reshape(-1),
                (ce[:, None] * sa[None, :]).reshape(-1),
                np.broadcast_to(se_[:, None], (n_rings, n_azimuth)).reshape(-1),
            ],
            axis=-1,
        )  # unit vectors
        d_w = d_v @ R_cv.T @ R

        rng_t, rng_id, rng_a, rng_b, _ = self._cast(o, d_w, t_min=min_range)
        hit = (rng_id >= 0) & (rng_t <= max_range)
        r = rng_t[hit]
        if noise_sigma > 0:
            nrng = np.random.RandomState(
                1 if noise_seed is None else noise_seed
            )
            r = r + nrng.randn(r.shape[0]) * noise_sigma
        pts = d_v[hit] * r[:, None]
        inten = np.full(r.shape[0], 0.3, np.float32)
        ids = rng_id[hit]
        for i, pl in enumerate(self.planes):
            sel = ids == i
            if not sel.any():
                continue
            lod = np.full(sel.sum(), 3.0, np.float32)
            inten[sel] = (
                _sample_trilinear(pl, rng_a[hit][sel], rng_b[hit][sel], lod)
                / 255.0
            )
        return np.concatenate(
            [pts.astype(np.float32), inten[:, None]], axis=-1
        )


# -- street-circuit scene ---------------------------------------------------

# Camera-from-velodyne rotation (velo x fwd, y left, z up -> cam x right,
# y down, z fwd) and a realistic mounting offset (velodyne ~8 cm above,
# 27 cm behind the camera — KITTI-like Tr magnitudes).
R_CAM_VELO = np.array(
    [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float64
)
T_CAM_VELO = np.eye(4)
T_CAM_VELO[:3, :3] = R_CAM_VELO
T_CAM_VELO[:3, 3] = np.array([0.0, -0.08, -0.27])

CAM_HEIGHT = 1.65  # camera above ground (world +y is DOWN; ground y=+1.65)
WALL_TOP = -4.2    # wall top edge (4.2 m above the camera plane)


def street_circuit_world(
    seed: int = 0,
    A: float = 60.0,
    B: float = 40.0,
    half_width: float = 11.0,
    texel: float = 0.015,
    panel_spacing: float = 22.0,
) -> PlaneWorld:
    """Rectangular street circuit: 4 outer + 4 inner facade walls, textured
    ground, and sign panels along the street for near-field parallax.

    The camera drives the centerline rectangle of half-extents (A, B) in
    the XZ plane (see `circuit_trajectory`); walls sit at lateral offset
    +-half_width."""
    rng = np.random.RandomState(seed)
    planes: List[Plane] = []
    Ao, Bo = A + half_width, B + half_width
    Ai, Bi = A - half_width, B - half_width
    y0, y1 = WALL_TOP, CAM_HEIGHT
    h = y1 - y0

    def wall(x0, z0, x1, z1):
        planes.append(
            _make_plane(
                rng,
                p0=(x0, y0, z0),
                e1=(x1 - x0, 0.0, z1 - z0),
                e2=(0.0, h, 0.0),
                texel=texel,
            )
        )

    # Outer box (faces inward).
    wall(+Ao, -Bo, +Ao, +Bo)
    wall(+Ao, +Bo, -Ao, +Bo)
    wall(-Ao, +Bo, -Ao, -Bo)
    wall(-Ao, -Bo, +Ao, -Bo)
    # Inner block (faces outward).
    wall(+Ai, -Bi, +Ai, +Bi)
    wall(+Ai, +Bi, -Ai, +Bi)
    wall(-Ai, +Bi, -Ai, -Bi)
    wall(-Ai, -Bi, +Ai, -Bi)
    # Ground (coarser texel: it is viewed at grazing angles where the mip
    # chain handles minification; 4 cm texels over 134x94 m would be 8M
    # texels for marginal benefit).
    planes.append(
        _make_plane(
            rng,
            p0=(-Ao - 2, CAM_HEIGHT, -Bo - 2),
            e1=(2 * (Ao + 2), 0.0, 0.0),
            e2=(0.0, 0.0, 2 * (Bo + 2)),
            texel=0.06,
        )
    )

    # Sign panels: along each straight, alternating sides, facing the
    # oncoming (counter-clockwise) camera. Each is 2.6 m wide, spanning
    # 0.6..3.1 m above ground.
    straights = [
        # (start xz, direction of travel, lateral-left unit)
        ((+A, -Bi + 3.0), (0.0, 1.0), (-1.0, 0.0)),
        ((+Ai - 3.0, +B), (-1.0, 0.0), (0.0, -1.0)),
        ((-A, +Bi - 3.0), (0.0, -1.0), (1.0, 0.0)),
        ((-Ai + 3.0, -B), (1.0, 0.0), (0.0, 1.0)),
    ]
    k = 0
    for (sx, sz), (dx, dz), (lx, lz) in straights:
        seg_len = 2 * (Bi - 3.0) if dx == 0.0 else 2 * (Ai - 3.0)
        n_panels = int(seg_len // panel_spacing)
        for j in range(n_panels):
            s = (j + 0.5) * panel_spacing
            side = 1.0 if (k % 2 == 0) else -1.0
            k += 1
            cx = sx + dx * s + lx * side * (half_width - 1.6)
            cz = sz + dz * s + lz * side * (half_width - 1.6)
            # Panel face perpendicular to travel: e1 = lateral, e2 = up.
            ex, ez = lx * 2.6, lz * 2.6
            planes.append(
                _make_plane(
                    rng,
                    p0=(cx - ex / 2, CAM_HEIGHT - 3.1, cz - ez / 2),
                    e1=(ex, 0.0, ez),
                    e2=(0.0, 2.5, 0.0),
                    texel=0.02,
                )
            )
    return PlaneWorld(planes)


def circuit_trajectory(
    n_frames: int,
    A: float = 60.0,
    B: float = 40.0,
    corner_r: float = 10.0,
    step: float = 0.8,
    start_s: float = 0.0,
    corner_slow: float = 0.45,
    ramp_m: float = 5.0,
):
    """T_cw poses driving the rounded-rectangle centerline counter-clockwise
    at `step` m/frame (KITTI is ~0.8-1.1 m/frame at 10 Hz). Corners are
    quarter arcs of radius `corner_r`, and the vehicle SLOWS to
    `corner_slow * step` through them with linear `ramp_m` on-ramps — real
    KITTI yaw rates stay under ~2 deg/frame at 10 Hz because cars brake for
    turns; a constant-speed 6 m-radius corner is 7.6 deg/frame (~96 px at
    fx=719), which no reference-gate tracker survives and no real sequence
    contains. Defaults give <=2.1 deg/frame. Returns (poses, perimeter_m)."""
    La = 2 * (B - corner_r)   # straights along z at x=+-A
    Lb = 2 * (A - corner_r)   # straights along x at z=+-B
    Qc = 0.5 * np.pi * corner_r
    perim = 2 * La + 2 * Lb + 4 * Qc

    def eval_s(s):
        s = s % perim
        # straight 1: x=+A, z from -(B-r) to +(B-r), heading +z
        if s < La:
            return np.array([A, -( B - corner_r) + s]), np.array([0.0, 1.0])
        s -= La
        # corner 1 at (A-r, B-r): heading +z -> -x
        if s < Qc:
            th = s / corner_r
            c = np.array([A - corner_r, B - corner_r])
            pos = c + corner_r * np.array([np.cos(th), np.sin(th)])
            tan = np.array([-np.sin(th), np.cos(th)])
            return pos, tan
        s -= Qc
        # straight 2: z=+B, x from A-r to -(A-r), heading -x
        if s < Lb:
            return np.array([(A - corner_r) - s, B]), np.array([-1.0, 0.0])
        s -= Lb
        # corner 2 at (-(A-r), B-r)
        if s < Qc:
            th = np.pi / 2 + s / corner_r
            c = np.array([-(A - corner_r), B - corner_r])
            pos = c + corner_r * np.array([np.cos(th), np.sin(th)])
            tan = np.array([-np.sin(th), np.cos(th)])
            return pos, tan
        s -= Qc
        # straight 3: x=-A, heading -z
        if s < La:
            return np.array([-A, (B - corner_r) - s]), np.array([0.0, -1.0])
        s -= La
        # corner 3 at (-(A-r), -(B-r))
        if s < Qc:
            th = np.pi + s / corner_r
            c = np.array([-(A - corner_r), -(B - corner_r)])
            pos = c + corner_r * np.array([np.cos(th), np.sin(th)])
            tan = np.array([-np.sin(th), np.cos(th)])
            return pos, tan
        s -= Qc
        # straight 4: z=-B, heading +x
        if s < Lb:
            return np.array([-(A - corner_r) + s, -B]), np.array([1.0, 0.0])
        s -= Lb
        # corner 4 at (A-r, -(B-r))
        th = 1.5 * np.pi + s / corner_r
        c = np.array([A - corner_r, -(B - corner_r)])
        pos = c + corner_r * np.array([np.cos(th), np.sin(th)])
        tan = np.array([-np.sin(th), np.cos(th)])
        return pos, tan

    # Corner spans in arc length (same order the eval_s cases consume).
    corner_spans = [
        (La, La + Qc),
        (La + Qc + Lb, La + 2 * Qc + Lb),
        (2 * La + 2 * Qc + Lb, 2 * La + 3 * Qc + Lb),
        (2 * La + 3 * Qc + 2 * Lb, perim),
    ]

    def speed_factor(s):
        s = s % perim
        f = 1.0
        for c0, c1 in corner_spans:
            if c0 <= s <= c1:
                return corner_slow
            # Linear ramps before/after (wrap-aware via both directions).
            d = min(
                abs(s - c0), abs(s - c1),
                abs(s + perim - c1), abs(s - perim - c0),
            )
            if d < ramp_m:
                f = min(f, corner_slow + (1 - corner_slow) * d / ramp_m)
        return f

    poses = []
    up = np.array([0.0, -1.0, 0.0])
    s_cur = start_s
    for i in range(n_frames):
        (px, pz), (tx, tz) = eval_s(s_cur)
        s_cur += step * speed_factor(s_cur)
        c_w = np.array([px, 0.0, pz])
        fwd = np.array([tx, 0.0, tz])
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(up, fwd)
        R_wc = np.stack([right, -up, fwd], axis=-1)
        R_cw = R_wc.T
        t_cw = -R_cw @ c_w
        poses.append(
            Pose(R_cw.astype(np.float32), t_cw.astype(np.float32))
        )
    return poses, perim


def center_scan_on_columns(points: np.ndarray, T_cam_velo: np.ndarray,
                           horizon_res_deg: float = 0.2):
    """Yaw a scan by half a range-image column about the sensor's z axis, and
    fold the inverse yaw into the extrinsics, so the same points reach the
    camera frame.

    `lidar_scan` casts its rays at azimuths k * 360 / n_azimuth exactly. When
    that step equals the range image's `horizon_res_deg`, every ray lies on a
    column edge, float32 rounding sends neighbouring rays into one column and
    leaves the next one empty, and no curvature window is complete: no LiDAR
    feature comes out. Half a column of yaw puts every ray at a column
    centre. Returns (points (N, 3) float32, T_cam_velo (4, 4) float64)."""
    a = np.deg2rad(0.5 * horizon_res_deg)
    Rz = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                   [0.0, 0.0, 1.0]])
    T = np.array(T_cam_velo, np.float64)
    T[:3, :3] = T[:3, :3] @ Rz.T
    return (np.asarray(points[:, :3], np.float64) @ Rz.T).astype(np.float32), T
