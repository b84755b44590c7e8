#!/usr/bin/env python3
"""Keyframes inserted by sync and by pipelined tracking, in both packages.

Runs tests/test_e2e_synthetic.py's sequence (SyntheticWorld(seed=3, 900
points), 25 frames at 0.4 m, 600 features) through the JAX package's
`SlamSystem` and the port's on the same images, once in sync mode and once
with `TrackingConfig(pipelined=True)`, and prints one JSON line per mode:
the keyframe count and the frame ids that became keyframes in each
package. Pipelined tracking decides frame t's keyframe after frame t+1 was
dispatched against the map without it, so the next frame tends to become
a keyframe as well.

    JAX_PLATFORMS=cpu python3 scripts/pipelined_keyframes.py   # ~2 min on 4 CPU threads
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
    from sqrtlm_slam_tpu.frontend import orb
    from sqrtlm_slam_tpu.pipeline import SlamSystem, SystemConfig, TrackingConfig
    from sqrtlm_slam_tpu_torch import convert
    from sqrtlm_slam_tpu_torch.pipeline import system as t_system

    torch.set_num_threads(4)
    world = SyntheticWorld(seed=3, n_points=900)
    frames = [tuple(np.array(a) for a in world.render(T, DEFAULT_CAM))
              for T in forward_trajectory(25, step=0.4)]
    for pipelined in (False, True):
        cfg = SystemConfig(
            orb=orb.ORBConfig(max_features=600),
            tracking=TrackingConfig(init_min_depth_kp=80, local_map_capacity=1024,
                                    pipelined=pipelined),
            max_keyframes=64, max_landmarks=8000)
        systems = {"jax": SlamSystem(DEFAULT_CAM, cfg),
                   "port": t_system.SlamSystem(convert.camera(DEFAULT_CAM),
                                               convert.system_config(cfg), device="cpu")}
        out = {"mode": "pipelined" if pipelined else "sync"}
        for name, s in systems.items():
            tracked = sum(s.track_depth(img, depth) is not None for img, depth in frames)
            s.get_trajectory()  # finalizes a deferred frame
            ids = sorted(int(f) for f in s.store.kf_frame_id[: s.store.num_kf])
            out[name] = {"tracked": tracked, "keyframes": s.num_keyframes(),
                         "keyframe_frame_ids": ids}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
