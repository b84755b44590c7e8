"""Synthetic inputs of relocalisation's and the loop's Sim3-verification
graphs, for holding each graph against its eager run (`chip_smoke.py`
phase 18 and the graph tests).

Everything is made from one RGB-D frame: its depth keypoints back-projected
are the local map and the loop's points, and 3D-3D matches under a known
Sim3 come from a seeded numpy stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..algorithm import pnp
from ..factors.reprojection import Camera
from ..geometry import sim3, so3
from ..loop import closing, sim3_solver
from ..pipeline import tracking
from ..pipeline.frame import Frame


def verification_calls(frame: Frame, cam: Camera, generator: torch.Generator) -> dict:
    """Graphed attribute name -> (graphed function, args, kwargs), at the
    default `TrackingConfig` and `LoopClosingConfig` (cfg):

      * `_recover_pose_jit`: a local map of `local_map_capacity` rows, the
        frame's depth keypoints moved 2 cm, against the frame; the uniforms
        drawn from `generator` in the eager order (the 3D-3D bank's, then
        the 2D-3D bank's);
      * `_ransac_sim3_jit` and `optimize_sim3`: `cfg.match_cap` 3D-3D
        matches under a Sim3 of scale 1.1 with 1 cm of noise, 300 valid;
        the refinement starts from its rotation and translation at scale 1;
      * `project_match`: the frame's points as the loop group, padded to
        `cfg.loop_points_cap` rows as `LoopCloser` pads it;
      * `guided_sim3_match`: the frame against itself, every third keypoint
        of the second side invalid."""
    cfg = closing.LoopClosingConfig()
    local_map_rows = tracking.TrackingConfig().local_map_capacity
    dev = frame.kp.xy.device
    kp, z = frame.kp, frame.depth
    n = z.shape[0]
    if n > local_map_rows:
        raise ValueError(f"{n} keypoints do not fit a local map of {local_map_rows} rows")
    pts = torch.stack([(kp.xy[:, 0] - cam.cx) * z / cam.fx,
                       (kp.xy[:, 1] - cam.cy) * z / cam.fy, z], -1)
    ok = (z > 0) & kp.valid
    pos = torch.zeros(local_map_rows, 3, device=dev)
    desc = torch.zeros(local_map_rows, kp.desc.shape[1], dtype=kp.desc.dtype, device=dev)
    valid = torch.zeros(local_map_rows, dtype=torch.bool, device=dev)
    pos[:n], desc[:n], valid[:n] = pts + 0.02, kp.desc, ok
    shape = (pnp.NUM_HYPOTHESES, local_map_rows)
    u3, u2 = (torch.rand(shape, generator=generator, device=dev) for _ in range(2))
    calls = {"_recover_pose_jit": (tracking._recover_pose_jit, (
        pos, desc, valid, kp.xy, kp.desc, kp.valid, z, frame.inv_sigma2, u3, u2, None, None,
        cam), {})}

    rng = np.random.RandomState(5)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    R, t = so3.exp(f32(rng.normal(size=3) * 0.1)), f32(rng.normal(size=3))
    m = cfg.match_cap
    x2 = f32(rng.uniform(-4, 4, (m, 3)) + [0, 0, 12])
    x1 = sim3.act(sim3.Sim3(torch.full((), 1.1, device=dev), R, t), x2) + f32(
        rng.normal(size=(m, 3)) * 0.01)
    matched = torch.arange(m, device=dev) < 300
    is2 = torch.ones(m, device=dev)
    u = torch.rand((128, m), generator=generator, device=dev)  # ransac_sim3's bank
    calls["_ransac_sim3_jit"] = (sim3_solver._ransac_sim3_jit,
                                 (x1, x2, matched, is2, is2, u, cam, cfg.fix_scale), {})
    calls["optimize_sim3"] = (sim3_solver.optimize_sim3, (
        sim3.Sim3(torch.ones((), device=dev), R, t), x1, x2, matched, is2, is2, cam),
        dict(fix_scale=cfg.fix_scale))

    M = cfg.loop_points_cap
    group = [torch.zeros(M, 3, device=dev), torch.zeros(M, kp.desc.shape[1], dtype=kp.desc.dtype,
                                                        device=dev),
             torch.zeros(M, dtype=torch.bool, device=dev),
             torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(M, 1), torch.zeros(M, device=dev),
             torch.full((M,), 1e6, device=dev)]
    group[0][:n], group[1][:n], group[2][:n] = pts, kp.desc, ok
    group[3][:n] = torch.nn.functional.normalize(pts, dim=-1)
    group[4][:n], group[5][:n] = 0.5 * pts.norm(dim=-1), 2.0 * pts.norm(dim=-1)
    octave = kp.octave.to(torch.int32)
    ident = sim3.Sim3(torch.ones((), device=dev), torch.eye(3, device=dev),
                      torch.zeros(3, device=dev))
    calls["project_match"] = (closing.project_match, (
        cam, ident, *group, kp.xy, kp.desc, octave, kp.valid, cfg.proj_search_radius), {})
    xk = torch.where(ok[:, None], pts, torch.zeros_like(pts))
    calls["guided_sim3_match"] = (closing.guided_sim3_match, (
        cam, ident, xk, ok, kp.desc, kp.xy, octave, xk,
        ok & (torch.arange(n, device=dev) % 3 > 0), kp.desc, kp.xy, octave,
        cfg.sim3_search_radius), {})
    return calls
