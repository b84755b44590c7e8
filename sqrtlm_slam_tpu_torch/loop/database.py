"""Place-recognition database: BoW scoring over the keyframe matrix.

The JAX package's `sqrtlm_slam_tpu/loop/database.py`, carried over
unchanged (pure numpy over the shared `MapStore`, so the port runs without
the JAX package; a test holds the two sources identical). The whole
keyframe BoW matrix is scored in one vectorized ``sum(min(q, M))`` pass (the
DBoW2 L1 score for L1-normalised vectors), with the reference's semantics:
loop candidates are not covisibility-connected to the query, the minimum
score is the worst covisible-neighbour score, candidate scores accumulate
over covisibility groups and are gated at 0.75x the best, and
relocalisation candidates skip the connected-keyframe exclusion.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..mapstore import MapStore


def _l1_scores(q: np.ndarray, M: np.ndarray) -> np.ndarray:
    """DBoW2 L1 similarity of q (W,) against rows of M (K, W)."""
    return np.minimum(q[None, :], M).sum(-1)


class KeyFrameDatabase:
    """Scores live against the store's `kf_bow` matrix (no copy kept)."""

    def __init__(self, store: MapStore):
        self.store = store

    # ------------------------------------------------------------------

    def min_covisible_score(self, kf: int) -> float:
        """Worst BoW score between kf and its covisible neighbors — the
        reference's candidate floor (LoopClosing.cc:196-221)."""
        store = self.store
        neigh = store.covisible_above(kf, 1)
        if len(neigh) == 0:
            return 1.0
        scores = _l1_scores(store.kf_bow[kf], store.kf_bow[neigh])
        return float(scores.min())

    def detect_loop_candidates(self, kf: int, min_score: float) -> List[int]:
        """Loop candidates for keyframe kf (KeyFrameDatabase.cc:104-263)."""
        store = self.store
        K = store.num_kf
        if K == 0:
            return []
        scores = _l1_scores(store.kf_bow[kf], store.kf_bow[:K])

        connected = np.zeros(K, bool)
        conn = store.covisible_above(kf, 1)
        connected[conn[conn < K]] = True
        connected[kf] = True
        valid = store.kf_valid[:K] & ~connected
        sharing = scores > 1e-6  # shares at least one word
        cand = np.where(valid & sharing & (scores >= min_score))[0]
        if len(cand) == 0:
            return []

        # Accumulate each candidate's score over its covisibility group
        # (top-10 neighbors), keeping the best-scoring group member.
        acc_scores = np.zeros(len(cand))
        best_member = np.zeros(len(cand), np.int64)
        for i, c in enumerate(cand):
            group = [int(c)] + [int(x) for x in store.best_covisible(int(c), 10)]
            group = [g for g in group if g < K and not connected[g]]
            g_scores = scores[group]
            acc_scores[i] = g_scores.sum()
            best_member[i] = group[int(np.argmax(g_scores))]

        best_acc = acc_scores.max()
        keep = acc_scores >= 0.75 * best_acc
        # Unique best members, ranked by accumulated score.
        order = np.argsort(-acc_scores)
        out, seen = [], set()
        for i in order:
            if not keep[i]:
                continue
            m = int(best_member[i])
            if m not in seen:
                seen.add(m)
                out.append(m)
        return out

    def detect_reloc_candidates(self, bow: np.ndarray) -> List[int]:
        """Relocalization candidates for a lost frame's BoW vector
        (KeyFrameDatabase.cc:265-402 — no connected-KF exclusion)."""
        store = self.store
        K = store.num_kf
        if K == 0:
            return []
        scores = _l1_scores(bow, store.kf_bow[:K])
        scores = np.where(store.kf_valid[:K], scores, 0.0)
        if scores.max() <= 1e-6:
            return []
        cand = np.where(scores >= 0.75 * scores.max())[0]
        return [int(c) for c in cand[np.argsort(-scores[cand])]][:10]
