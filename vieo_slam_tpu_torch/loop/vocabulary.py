"""Binary-descriptor vocabulary: hierarchical k-medians bag of words.

Port of vieo_slam_tpu/loop/vocabulary.py (the online-trained vocabulary
the loop closer uses; DBoW2 file I/O comes with the I/O slice).  Training
is numpy, copied so that the same descriptors and seed give the same tree
bit for bit.  BoW vectors are dense [n_words] and scored with one batched
L1 reduction.  The tree descent (`transform`) runs on the descriptors'
device: L rounds of a Hamming argmin over the k children of every
descriptor's current node, all descriptors at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.cuda_matching import popcount32


@dataclasses.dataclass
class Vocabulary:
    k: int                     # branching factor
    L: int                     # depth (words = k^L leaves)
    node_desc: np.ndarray      # [n_nodes, 8] uint32, level-major layout
    idf: np.ndarray            # [k^L] float32 word weights
    _on: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

    @property
    def n_words(self) -> int:
        return self.k ** self.L

    def level_slice(self, level: int):
        """Nodes of `level` (1-based) start at k*(k^(level-1)-1)/(k-1)."""
        k = self.k
        start = k * (k ** (level - 1) - 1) // (k - 1)
        return start, start + k ** level

    def tensors(self, device):
        """(node descriptors as int32 bits, idf) on `device`, made once."""
        key = str(device)
        if key not in self._on:
            nodes = np.ascontiguousarray(self.node_desc, np.uint32)
            self._on[key] = (
                torch.from_numpy(nodes.view(np.int32).copy()).to(device),
                torch.from_numpy(np.asarray(self.idf, np.float32)).to(device))
        return self._on[key]


def _popcount_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distances [N, M] between uint32[ N,8] and [M,8] (numpy)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_centroid(desc: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid of uint32 [N, 8] descriptors."""
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)       # [N, 256]
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train_vocabulary(descriptors: np.ndarray, *, k: int = 10, L: int = 3,
                     seed: int = 0, iters: int = 8) -> Vocabulary:
    """Hierarchical binary k-medians. descriptors: [N, 8] uint32."""
    rng = np.random.RandomState(seed)
    desc = np.unique(descriptors, axis=0)

    def kmedians(data):
        n = len(data)
        if n == 0:
            return np.zeros((k, 8), np.uint32), np.zeros(0, np.int64)
        init = data[rng.choice(n, size=min(k, n), replace=False)]
        cents = np.concatenate(
            [init, data[rng.randint(0, n, k - len(init))]]) \
            if len(init) < k else init
        for _ in range(iters):
            d = _popcount_rows(data, cents)
            assign = d.argmin(1)
            for c in range(k):
                sel = data[assign == c]
                if len(sel):
                    cents[c] = _majority_centroid(sel)
                else:  # re-seed empty cluster
                    cents[c] = data[rng.randint(0, n)]
        d = _popcount_rows(data, cents)
        return cents, d.argmin(1)

    # Level by level: node_desc laid out level-major, children of node i at
    # positions i*k..i*k+k-1 of the next level.
    groups = [desc]
    all_nodes = []
    for _ in range(L):
        next_groups = []
        level_nodes = []
        for g in groups:
            cents, assign = kmedians(g)
            level_nodes.append(cents)
            for c in range(k):
                next_groups.append(g[assign == c] if len(g) else g)
        all_nodes.append(np.concatenate(level_nodes))
        groups = next_groups

    node_desc = np.concatenate(all_nodes).astype(np.uint32)
    counts = np.asarray([len(g) for g in groups], np.float64)
    idf = np.log(max(len(desc), 1) / np.maximum(counts, 1.0)).astype(
        np.float32)
    return Vocabulary(k=k, L=L, node_desc=node_desc, idf=idf)


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Descend the tree for every descriptor at once on desc's device.

    desc [N, 8] int32 bits, valid [N] bool.  Returns (bow [n_words] f32
    L1-normalized tf-idf, word_id [N] int32 with -1 for invalid rows);
    ties between children go to the lowest index."""
    k, L = voc.k, voc.L
    nodes, idf = voc.tensors(desc.device)
    ar = torch.arange(k, device=desc.device)
    cur = torch.zeros(desc.shape[0], dtype=torch.long, device=desc.device)
    for lv in range(L):
        child_base = cur * k
        off = voc.level_slice(lv + 1)[0]
        cand = nodes[off + child_base[:, None] + ar[None, :]]   # [N, k, 8]
        d = popcount32(desc[:, None, :] ^ cand).sum(-1)          # [N, k]
        cur = child_base + torch.argmin(d, dim=-1)
    word = torch.where(valid, cur, -1).int()
    counts = torch.zeros(voc.n_words, dtype=torch.float32,
                         device=desc.device).index_add_(
        0, word.clamp_min(0).long(), valid.float())
    bow = counts * idf
    norm = torch.sum(torch.abs(bow))
    return bow / torch.clamp_min(norm, 1e-12), word


def score_l1(bow_q: torch.Tensor, bows: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score s = 1 - 0.5 |q - d|_1 of L1-normalized vectors:
    bow_q [W], bows [K, W] -> [K]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(bow_q[None, :] - bows), dim=-1)
