"""Binary vocabulary + bag-of-words vectors (the DBoW2 replacement).

Counterpart of `sqrtlm_slam_tpu/frontend/vocab.py`: a flattened k-ary
k-medians tree over packed 256-bit descriptors; word assignment for a whole
frame is a batched Hamming argmin descent (one gather + popcount round per
level); BoW vectors are dense L1-normalised tf-idf arrays scored by
``sum(min(q, m))``. Descriptors and centroids are (N, 8) int32 holding the
uint32 bits (`utils.desc_to_torch`); popcount is the port's byte table.

`load_default` reads the shipped vocabulary from the port's own asset
(`sqrtlm_slam_tpu_torch/assets/orbvoc_synth_k10_d4.npz`, a byte-for-byte copy
of the JAX package's) by file path with numpy;
`train` is the same host-side numpy k-medians, for systems built without a
vocabulary; `save` writes the JAX package's npz layout.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.hamming import popcount_words
from ..utils import desc_to_numpy, desc_to_torch

DEFAULT_ASSET = Path(__file__).resolve().parents[1] / "assets" / "orbvoc_synth_k10_d4.npz"


class Vocabulary(NamedTuple):
    """Flattened k-ary tree. Level l has k^(l+1) centroids; children of node
    n at level l are rows [n*k, (n+1)*k) of centroids[l]."""

    centroids: tuple  # length-L tuple of (k^(l+1), 8) int32 tensors
    idf: torch.Tensor  # (num_words,) float32 inverse document frequency
    k: int

    @property
    def num_words(self) -> int:
        return self.centroids[-1].shape[0]

    @property
    def depth(self) -> int:
        return len(self.centroids)


_POP_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _hamming_chunked(data: np.ndarray, cents: np.ndarray, chunk: int = 65536) -> np.ndarray:
    """(n, kk) Hamming distances of uint32 words with bounded temporaries."""
    n, kk = data.shape[0], cents.shape[0]
    out = np.empty((n, kk), np.int32)
    for s in range(0, n, chunk):
        x = np.bitwise_xor(data[s: s + chunk, None, :], cents[None, :, :])
        out[s: s + chunk] = _POP_LUT[x.view(np.uint8)].sum(-1, dtype=np.int32)
    return out


def _majority_medoid(descs: np.ndarray) -> np.ndarray:
    """Majority bit vote over packed uint32 descriptors -> one centroid."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # (N, 256)
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train(descriptors: np.ndarray, k: int = 10, depth: int = 3, iters: int = 8,
          seed: int = 0, device="cuda") -> Vocabulary:
    """Hierarchical binary k-medians (numpy, host). descriptors: (N, 8)
    uint32 (N >= k^depth). The vocabulary is returned on `device`."""
    rng = np.random.RandomState(seed)
    descs = np.ascontiguousarray(descriptors.astype(np.uint32))

    def kmedians(data, kk):
        n = data.shape[0]
        if n == 0:
            return np.zeros((kk, 8), np.uint32), np.zeros((0,), np.int64)
        init = data[rng.choice(n, size=min(kk, n), replace=False)]
        cents = np.zeros((kk, 8), np.uint32)
        cents[: init.shape[0]] = init
        assign = np.zeros(n, np.int64)
        for _ in range(iters):
            assign = _hamming_chunked(data, cents).argmin(1)
            for c in range(kk):
                sel = data[assign == c]
                if len(sel):
                    cents[c] = _majority_medoid(sel)
                else:  # re-seed an empty cluster
                    cents[c] = data[rng.randint(n)]
        return cents, assign

    levels = []
    groups = {(): descs}
    for lvl in range(depth):
        cents_lvl = np.zeros((k ** (lvl + 1), 8), np.uint32)
        new_groups = {}
        for path, data in groups.items():
            base = 0
            for p in path:
                base = base * k + p
            cents, assign = kmedians(data, k)
            cents_lvl[base * k: (base + 1) * k] = cents
            for c in range(k):
                new_groups[path + (c,)] = data[assign == c]
        levels.append(desc_to_torch(cents_lvl, device))
        groups = new_groups

    # idf from the training corpus: idf_w = log(N / (1 + n_w)).
    voc = Vocabulary(centroids=tuple(levels),
                     idf=torch.ones(k ** depth, dtype=torch.float32, device=device), k=k)
    d = desc_to_torch(descs, device)
    words = assign_words(voc, d, torch.ones(len(descs), dtype=torch.bool, device=device))
    counts = np.bincount(words.cpu().numpy(), minlength=k ** depth).astype(np.float32)
    idf = np.maximum(np.log(len(descs) / (1.0 + counts)), 0.0) + 1e-3
    return voc._replace(idf=torch.as_tensor(idf.astype(np.float32), device=device))


def assign_words(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descend the tree: (N, 8) int32 descriptors -> (N,) int32 word ids
    (-1 where not valid). Ties go to the lowest child, as `jnp.argmin`."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    kids = torch.arange(voc.k, dtype=torch.int64, device=desc.device)
    for lvl in range(voc.depth):
        child_ids = node[:, None] * voc.k + kids[None, :]
        cand = voc.centroids[lvl][child_ids]  # (N, k, 8)
        d = popcount_words(torch.bitwise_xor(desc[:, None, :], cand))
        node = torch.gather(child_ids, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
    return torch.where(valid, node, torch.full_like(node, -1)).to(torch.int32)


def bow_vector(voc: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """(N,) word ids -> L1-normalised tf-idf vector (num_words,)."""
    tf = torch.bincount(words[words >= 0].long(), minlength=voc.num_words)
    v = tf.to(torch.float32) * voc.idf
    return v / torch.clamp(torch.sum(v), min=1e-9)


def l1_score(q: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of query q (W,) against rows of M (K, W)."""
    return torch.sum(torch.minimum(q[None, :], M), dim=-1)


def bow_window_mask(words_q: torch.Tensor, words_t: torch.Tensor, levels_up: int = 0,
                    k: int = 10) -> torch.Tensor:
    """(Q, T) mask of same-node pairs (the DBoW2 direct-index gate); with
    `levels_up` > 0 it gates on the ancestors ``word // k**levels_up``."""
    if levels_up > 0:
        div = k ** levels_up
        words_q = torch.where(words_q >= 0, torch.div(words_q, div, rounding_mode="floor"),
                              torch.full_like(words_q, -1))
        words_t = torch.where(words_t >= 0, torch.div(words_t, div, rounding_mode="floor"),
                              torch.full_like(words_t, -1))
    return (words_q[:, None] == words_t[None, :]) & (words_q[:, None] >= 0)


def save(voc: Vocabulary, path) -> None:
    """Write `voc` as the JAX package writes one (npz keys `k`, `depth`,
    `idf`, `level<i>` of uint32 words): each package loads the other's."""
    np.savez_compressed(
        path,
        k=np.int64(voc.k),
        depth=np.int64(voc.depth),
        idf=voc.idf.detach().cpu().numpy(),
        **{f"level{i}": desc_to_numpy(c) for i, c in enumerate(voc.centroids)},
    )


def load(path, device="cuda") -> Vocabulary:
    """Read a vocabulary written by `save` (of either package)."""
    z = np.load(path)
    depth = int(z["depth"])
    return Vocabulary(
        centroids=tuple(desc_to_torch(z[f"level{i}"], device) for i in range(depth)),
        idf=torch.as_tensor(np.asarray(z["idf"], np.float32), device=device),
        k=int(z["k"]),
    )


def load_default(device="cuda") -> Optional[Vocabulary]:
    """The shipped synthetic-domain vocabulary, or None if absent."""
    return load(DEFAULT_ASSET, device) if DEFAULT_ASSET.exists() else None
