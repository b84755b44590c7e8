"""Map checkpoint / resume.

Counterpart of `sqrtlm_slam_tpu/mapstore/checkpoint.py`, with the same npz
layout: a checkpoint written by either package loads in the other. The full
SoA map state (keyframes, landmarks, observations, covisibility, spanning
tree, loop edges, LiDAR clouds, counters) and the BoW vocabulary round-trip
through one compressed npz; the arrays are the map, so serialization is
exact. Tracker and loop-closer runtime state stays out: a resumed system
relocalises against the loaded map.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..frontend.vocab import Vocabulary
from ..utils import desc_to_numpy, desc_to_torch
from .store import MapStore

_FIELDS = [
    "kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_xy", "kf_uvr", "kf_depth",
    "kf_desc", "kf_angle", "kf_octave", "kf_kp_valid", "kf_words", "kf_bow",
    "kf_obs_lm",
    "kf_corner", "kf_corner_valid", "kf_flat", "kf_flat_normal", "kf_flat_valid",
    "lm_pos", "lm_valid", "lm_desc", "lm_normal", "lm_min_dist", "lm_max_dist",
    "lm_obs_kf", "lm_obs_idx", "lm_n_obs", "lm_visible", "lm_found",
    "lm_first_kf",
    "covis", "parent",
]

_META = ["max_keyframes", "max_landmarks", "feats_per_kf", "obs_per_landmark",
         "num_words", "corner_per_kf", "flat_per_kf", "num_kf", "num_lm"]


def save_map(store: MapStore, path: str, vocabulary: Vocabulary = None):
    """Write the full map state (+ the BoW vocabulary, without which the
    stored kf_bow / kf_words mean nothing) to `path` (.npz)."""
    arrays = {f: getattr(store, f) for f in _FIELDS}
    meta = {m: int(getattr(store, m)) for m in _META}
    meta["loop_edges"] = [list(map(int, e)) for e in store.loop_edges]
    if vocabulary is not None:
        meta["vocab_k"] = int(vocabulary.k)
        meta["vocab_depth"] = int(vocabulary.depth)
        for i, c in enumerate(vocabulary.centroids):
            arrays[f"__vocab_c{i}__"] = desc_to_numpy(c)
        arrays["__vocab_idf__"] = vocabulary.idf.detach().cpu().numpy()
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_map(path: str, device="cuda"):
    """Reconstruct (MapStore, Vocabulary-or-None) from a checkpoint; the
    vocabulary's tensors go to `device`."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    store = MapStore(
        max_keyframes=meta["max_keyframes"],
        max_landmarks=meta["max_landmarks"],
        feats_per_kf=meta["feats_per_kf"],
        obs_per_landmark=meta["obs_per_landmark"],
        num_words=meta["num_words"],
        corner_per_kf=meta.get("corner_per_kf", 512),
        flat_per_kf=meta.get("flat_per_kf", 1024),
    )
    for f in _FIELDS:
        getattr(store, f)[...] = data[f]
    store.num_kf = meta["num_kf"]
    store.num_lm = meta["num_lm"]
    store.loop_edges = [tuple(e) for e in meta["loop_edges"]]

    voc = None
    if "vocab_k" in meta:
        cents = tuple(desc_to_torch(data[f"__vocab_c{i}__"], device)
                      for i in range(meta["vocab_depth"]))
        voc = Vocabulary(centroids=cents, k=meta["vocab_k"],
                         idf=torch.as_tensor(data["__vocab_idf__"], device=device))
    return store, voc
