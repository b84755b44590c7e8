#!/usr/bin/env python3
"""Stereo tracking of the port at KITTI size on two scenes, with and without
image noise, and the stereo frames of one device tracked on the other.

    python3 scripts/stereo_scenes.py                 # one CUDA card
    python3 scripts/stereo_scenes.py --device cpu --frames 4   # rehearsal

Scenes (KITTI 00-02 intrinsics at 1226x370, 2000 ORB features, the right
camera moved by b = bf / fx along x, default tracking config):
  * `points`: chip_smoke.py phase 4's synthetic world (random binary
    patches, seed 1, 3000 points), 0.3 m steps;
  * `street`: `planeworld.street_circuit_world(seed=0)` from 54 m along the
    circuit at 0.8 m steps (chip_smoke.py phases 10 and 12).
For each scene and noise seed (0: the rendered images; k > 0: Gaussian
noise of 1e-3 added to both images from seed k) one JSON line: frame 0's
stereo matches, their median relative depth error and gross mismatches
(> 20% off the rendered depth), how many of the 300 nearest (the first
keyframe's landmarks) are gross, frames tracked, keyframes, the camera
centre's error at frame 1 and the ATE. With a card, a last line per scene
tracks the first frames built on each device on the other device.
The first line is the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448)
H, W = 370, 1226


def scene(name: str, n: int, cam):
    """(left images, right images, frame-0 depth, T_cw poses)."""
    from sqrtlm_slam_tpu_torch.eval import planeworld, synthetic

    b = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    if name == "points":
        world = synthetic.SyntheticWorld(seed=1, n_points=3000)
        poses = synthetic.forward_trajectory(n, step=0.3)
        render = lambda T, i: world.render(T, cam, H=H, W=W)  # noqa: E731
    else:
        world = planeworld.street_circuit_world(seed=0)
        poses, _ = planeworld.circuit_trajectory(n, step=0.8, start_s=54.0)
        render = lambda T, i: world.render(T, cam, H=H, W=W, noise_seed=i)  # noqa: E731
    lefts, rights, depth0 = [], [], None
    for i, T in enumerate(poses):
        img, depth = render(T, i)
        depth0 = depth if i == 0 else depth0
        lefts.append(img)
        rights.append(render(synthetic.Pose(T.R, T.t - b), 100 + i)[0])
    return lefts, rights, depth0, poses


def camera_to_world(poses) -> np.ndarray:
    out = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = np.asarray(T.R), np.asarray(T.t)
        out.append(np.linalg.inv(M))
    out = np.stack(out)
    return np.linalg.inv(out[0]) @ out  # the map's frame is the first camera's


def frame_stats(frame, depth0):
    """Frame 0's stereo matches against the rendered depth."""
    from sqrtlm_slam_tpu_torch.utils import to_host

    d, xy = to_host(frame.depth, frame.kp.xy)
    gt = depth0[np.clip(xy[:, 1].astype(int), 0, H - 1), np.clip(xy[:, 0].astype(int), 0, W - 1)]
    ok = (d > 0) & (gt > 0)
    rel = np.abs(d - gt) / np.maximum(gt, 1e-6)
    nearest = np.argsort(np.where(d > 0, d, np.inf))[:300]
    near_ok = (d[nearest] > 0) & (gt[nearest] > 0)
    return dict(matches=int((d > 0).sum()), depth_median_rel_err=float(np.median(rel[ok])),
                gross=int((rel[ok] > 0.2).sum()),
                gross_among_nearest_300=int((rel[nearest][near_ok] > 0.2).sum()))


def track(frames, cam, device, gt):
    """Track pre-built frames on `device`: (tracked, keyframes, frame-1
    centre error, ATE)."""
    import torch

    from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
    from sqrtlm_slam_tpu_torch.frontend.orb import Keypoints, ORBConfig
    from sqrtlm_slam_tpu_torch.pipeline.frame import Frame
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig

    s = SlamSystem(cam, SystemConfig(orb=ORBConfig(max_features=2000)), device=device)
    tracked = 0
    for f in frames:
        f = Frame(kp=Keypoints(*(x.to(device) for x in f.kp)), uvr=f.uvr.to(device),
                  depth=f.depth.to(device), inv_sigma2=f.inv_sigma2.to(device))
        tracked += s.track_frame(f) is not None
        if device.type == "cuda":
            torch.cuda.synchronize()
    est = s.get_trajectory()
    err1 = float(np.linalg.norm(est[1][:3, 3] - gt[1][:3, 3])) if len(est) > 1 else None
    return tracked, s.num_keyframes(), err1, ate_rmse(est, gt[: len(est)], align_scale=False)[0]


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--noise-seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--cross-frames", type=int, default=4)
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("stereo_scenes: needs a CUDA device (or --device cpu)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.pipeline.frame import build_frame_stereo

    dev = torch.device(args.device)
    cam = Camera(**KITTI)
    orb_cfg = ORBConfig(max_features=2000)

    def build(lefts, rights, device, k):
        return build_frame_stereo(torch.as_tensor(lefts[k], device=device),
                                  torch.as_tensor(rights[k], device=device), cam, orb_cfg)

    for name in ("points", "street"):
        lefts, rights, depth0, poses = scene(name, args.frames, cam)
        gt = camera_to_world(poses)
        for seed in args.noise_seeds:
            rng = np.random.RandomState(seed)

            def noisy(img):
                return img + rng.randn(*img.shape).astype(np.float32) * 1e-3 if seed else img

            L = [noisy(x) for x in lefts]
            R = [noisy(x) for x in rights]
            frames = [build(L, R, dev, k) for k in range(len(L))]
            tracked, kfs, err1, ate = track(frames, cam, dev, gt)
            print(json.dumps({"scene": name, "device": str(dev), "noise_seed": seed,
                              **frame_stats(frames[0], depth0), "frames": len(L),
                              "tracked": tracked, "keyframes": kfs, "frame1_err_m": err1,
                              "ate_m": ate}), flush=True)
        if dev.type == "cuda":
            n = min(args.cross_frames, len(lefts))
            cpu = torch.device("cpu")
            on_card = [build(lefts, rights, dev, k) for k in range(n)]
            on_cpu = [build(lefts, rights, cpu, k) for k in range(n)]
            out = {"scene": name, "frames": n}
            for label, frames, device in (("card_frames_on_cpu", on_card, cpu),
                                          ("cpu_frames_on_card", on_cpu, dev),
                                          ("card_frames_on_card", on_card, dev),
                                          ("cpu_frames_on_cpu", on_cpu, cpu)):
                tracked, kfs, err1, ate = track(frames, cam, device, gt)
                out[label] = dict(keyframes=kfs, frame1_err_m=err1, ate_m=ate)
            out["frame0_card"] = frame_stats(on_card[0], depth0)
            out["frame0_cpu"] = frame_stats(on_cpu[0], depth0)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
