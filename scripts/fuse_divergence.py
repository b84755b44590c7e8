#!/usr/bin/env python3
"""Why `SearchAndFuse` merges a different number of landmarks on the card
and on the CPU over the same ring loop.

    python3 scripts/fuse_divergence.py            # one CUDA card
    python3 scripts/fuse_divergence.py --frames 60 --device cpu   # rehearsal

The ring scene of tests/test_e2e_loop.py (`ring_world(7, 2500)`, 160 frames
at frac 1.3, 240x320, 600 ORB features, `loop_detection=True`) runs on each
device up to its first closed loop. At the loop correction the closer's
inputs are captured: a copy of the map store, the current and loop
keyframes, the Sim3 S12 it starts from and the guided matches. Then:
  1. isolation: each capture is replayed through `LoopCloser.correct_loop`
     (global BA off) on the card and on the CPU, and the merges that
     `SearchAndFuse` makes (landmark, keyframe, keypoint) are compared;
  2. upstream: the two runs are compared at their loops (frame, keyframes,
     landmarks, the loop pair, S12, the merge count), and ORB descriptors
     extracted on the card and on the CPU from every 8th frame are compared
     (keypoints, share of differing descriptors, mean differing bits).
Prints one JSON object per part; the first line is the card's name and power
limit from nvidia-smi. With `--device cpu` only the CPU run is made (the
replay then runs on the CPU twice).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ring_frames(n_frames: int):
    from sqrtlm_slam_tpu_torch.eval import synthetic

    world = synthetic.ring_world(seed=7, n_points=2500)
    poses = synthetic.ring_trajectory(160, frac=1.3)[:n_frames]
    return [world.render(T, synthetic.DEFAULT_CAM) for T in poses]


def run_to_first_loop(frames, device):
    """Track `frames` on `device` until the first loop closes. Returns
    (capture, summary): the closer's inputs at that loop's correction (None
    if no loop closed) and the run's numbers at its end."""
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.loop import LoopClosingConfig
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig

    system = SlamSystem(synthetic.DEFAULT_CAM, SystemConfig(orb=ORBConfig(max_features=600),
                                                            loop_detection=True),
                        device=device, loop_cfg=LoopClosingConfig())
    lc = system.loop_closer
    captured = {}
    correct = lc.correct_loop

    def capturing(kf_cur, kf_loop, S12, matches=None):
        if not captured:
            captured.update(store=copy.deepcopy(lc.store), kf_cur=kf_cur, kf_loop=kf_loop,
                            S12=tuple(np.asarray(a.cpu(), np.float32) for a in S12),
                            matches=copy.deepcopy(matches), frame=system.tracker.frame_idx)
        return correct(kf_cur, kf_loop, S12, matches)

    lc.correct_loop = capturing
    t0 = time.perf_counter()
    for i, (img, depth) in enumerate(frames):
        system.track_depth(img, depth)
        if lc.num_loops_closed:
            break
    summary = dict(device=str(device), frames_run=i + 1, seconds=time.perf_counter() - t0,
                   keyframes=system.num_keyframes(), landmarks=system.num_landmarks(),
                   loops_closed=lc.num_loops_closed, loops_rejected=lc.num_loops_rejected,
                   last_fused=lc.last_fused)
    if captured:
        s, R, t = captured["S12"]
        summary.update(loop_frame=captured["frame"], kf_cur=captured["kf_cur"],
                       kf_loop=captured["kf_loop"], S12_s=float(s), S12_R=R.tolist(),
                       S12_t=t.tolist(), keyframes_at_loop=int(captured["store"].num_kf),
                       landmarks_at_loop=int(captured["store"].lm_valid.sum()))
    return (captured or None), summary


def replay(capture, device):
    """`correct_loop` on a copy of the captured store, on `device`, global BA
    off. Returns (merge list [(lm, kf, kp)], committed)."""
    import torch

    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.geometry import sim3
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig

    store = copy.deepcopy(capture["store"])
    lc = LoopCloser(store, synthetic.DEFAULT_CAM, cfg=LoopClosingConfig(run_gba=False),
                    device=device)
    merges = []
    fuse = lc._fuse_point

    def recording(lm, kf, kp):
        out = fuse(lm, kf, kp)
        if out:
            merges.append((lm, kf, kp))
        return out

    lc._fuse_point = recording
    S12 = sim3.Sim3(*(torch.as_tensor(a) for a in capture["S12"]))
    ok = lc.correct_loop(capture["kf_cur"], capture["kf_loop"], S12,
                         copy.deepcopy(capture["matches"]))
    assert lc.last_fused == len(merges)
    return merges, bool(ok)


def orb_descriptor_diff(frames, devices, every: int = 8):
    """Keypoints and descriptors of `extract` on the two devices."""
    import torch

    from sqrtlm_slam_tpu_torch.frontend import orb
    from sqrtlm_slam_tpu_torch.utils import desc_to_numpy

    cfg = orb.ORBConfig(max_features=600)
    same_kp, n_kp, n_diff, bits = 0, 0, 0, []
    for img, _ in frames[::every]:
        a, b = (orb.extract(torch.as_tensor(img, device=d), cfg) for d in devices)
        xy_a, xy_b = a.xy.cpu().numpy(), b.xy.cpu().numpy()
        va, vb = a.valid.cpu().numpy(), b.valid.cpu().numpy()
        same_kp += int(np.array_equal(xy_a[va], xy_b[vb]) and np.array_equal(va, vb))
        both = va & vb & np.all(xy_a == xy_b, axis=1)
        da, db = desc_to_numpy(a.desc)[both], desc_to_numpy(b.desc)[both]
        x = np.unpackbits((da ^ db).view(np.uint8), axis=1).sum(axis=1)
        n_kp += int(both.sum())
        n_diff += int((x > 0).sum())
        bits.extend(x[x > 0].tolist())
    return dict(frames=len(frames[::every]), frames_with_equal_keypoints=same_kp,
                keypoints_compared=n_kp, share_differing=n_diff / max(n_kp, 1),
                mean_bits_of_differing=float(np.mean(bits)) if bits else 0.0,
                max_bits=int(max(bits)) if bits else 0)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("fuse_divergence: needs a CUDA device (or --device cpu)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    devices = [torch.device("cuda", 0), torch.device("cpu")] if args.device == "cuda" \
        else [torch.device("cpu")] * 2
    frames = ring_frames(args.frames)

    captures = {}
    for d in dict.fromkeys(devices):
        cap, summary = run_to_first_loop(frames, d)
        captures[str(d)] = cap
        print(json.dumps({"part": "run", **summary}), flush=True)
    for name, cap in captures.items():
        if cap is None:
            continue
        (m_a, ok_a), (m_b, ok_b) = (replay(cap, d) for d in devices)
        print(json.dumps({
            "part": "replay", "capture_from": name, "devices": [str(d) for d in devices],
            "merges": [len(m_a), len(m_b)], "committed": [ok_a, ok_b],
            "same_merges": m_a == m_b, "only_first": len(set(m_a) - set(m_b)),
            "only_second": len(set(m_b) - set(m_a))}), flush=True)
    print(json.dumps({"part": "orb", "devices": [str(d) for d in devices],
                      **orb_descriptor_diff(frames, devices)}), flush=True)


if __name__ == "__main__":
    main()
