"""Keyframe place-recognition database.

Host copy of vieo_slam_tpu/loop/keyframe_db.py: a dense [K, W] BoW matrix
scored against a query in one batched L1 reduction (`score_l1`), then
the reference's gating -- covisible keyframes excluded, the minimum score
taken from the query's covisible neighbourhood, and covisibility-group
score accumulation with the 0.75-of-best acceptance.
"""

from __future__ import annotations

import numpy as np
import torch

from .vocabulary import score_l1


class KeyFrameDatabase:
    def __init__(self, n_words: int, capacity: int = 1024):
        self.bows = np.zeros((capacity, n_words), np.float32)
        self.present = np.zeros(capacity, bool)

    def add(self, kf_id: int, bow: np.ndarray):
        self.bows[kf_id] = bow
        self.present[kf_id] = True

    def erase(self, kf_id: int):
        self.present[kf_id] = False
        self.bows[kf_id] = 0.0

    def scores(self, bow_q: np.ndarray) -> np.ndarray:
        s = score_l1(torch.from_numpy(np.asarray(bow_q, np.float32)),
                     torch.from_numpy(self.bows)).numpy()
        s[~self.present] = -1.0
        return s

    def detect_loop_candidates(
        self, bow_q: np.ndarray, query_kf: int,
        connected: np.ndarray, covisible_of,
        *, min_score_floor: float = 0.01, top_n: int = 8,
    ) -> np.ndarray:
        """Loop candidates for `query_kf`.

        connected: kf ids covisible with the query (excluded; their scores
        set the minimum score).  covisible_of: kf_id -> neighbour ids (for
        group scores)."""
        s = self.scores(bow_q)
        conn = np.asarray(connected, int)
        min_score = max(float(s[conn].min()) if conn.size else 0.0,
                        min_score_floor)
        s[conn] = -1.0
        s[query_kf] = -1.0
        cands = np.nonzero(s >= min_score)[0]
        if cands.size == 0:
            return cands
        # Covisibility-group accumulated score: the query's score summed
        # over each candidate's top-10 covisible group.
        acc = np.zeros(len(cands))
        for i, c in enumerate(cands):
            group = np.concatenate([[c], covisible_of(int(c))[:10]])
            acc[i] = s[np.asarray(group, int)].clip(0).sum()
        best = acc.max()
        keep = cands[acc >= 0.75 * best]
        order = np.argsort(-s[keep], kind="stable")
        return keep[order][:top_n]

    def detect_reloc_candidates(self, bow_q: np.ndarray, *, top_n: int = 5):
        s = self.scores(bow_q)
        order = np.argsort(-s, kind="stable")
        order = order[s[order] > 0]
        return order[:top_n]
