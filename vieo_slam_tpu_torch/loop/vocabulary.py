"""Binary-descriptor vocabulary: hierarchical k-medians bag of words.

Port of vieo_slam_tpu/loop/vocabulary.py: the online-trained vocabulary
the loop closer uses, and the DBoW2 text and binary vocabulary files
(ORBvoc.txt / ORBvoc.bin), read into and written from the dense
level-major tree (numpy, copied).  Training
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


# ---------------------------------------------------------------------------
# DBoW2/ORBvoc text-format interop (TemplatedVocabulary.h:1196
# loadFromTextFile / :1339 saveToTextFile): header "k L scoring weighting",
# then one line per non-root node, ids implied by file order (root = 0):
#   parent_id is_leaf d0 .. d31 weight
# ---------------------------------------------------------------------------


def save_dbow_text(voc: Vocabulary, path: str):
    """Write the vocabulary in DBoW2's text format (nodes level-major, so
    parents always precede children; weights stored on leaves)."""
    k, L = voc.k, voc.L
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        # file node ids: root 0, then our level-major order shifted by 1.
        for lv in range(1, L + 1):
            start, end = voc.level_slice(lv)
            pstart = voc.level_slice(lv - 1)[0] if lv > 1 else None
            for i in range(start, end):
                within = i - start
                if lv == 1:
                    pid = 0
                else:
                    pid = pstart + within // k + 1   # +1: root shift
                is_leaf = int(lv == L)
                dbytes = voc.node_desc[i].view(np.uint8)
                dstr = " ".join(str(int(b)) for b in dbytes)
                w = float(voc.idf[i - start]) if is_leaf else 0.0
                f.write(f"{pid} {is_leaf} {dstr} {w}\n")


def load_dbow_text(path: str) -> Vocabulary:
    """Load a DBoW2/ORBvoc text vocabulary into the dense level-major
    layout `transform` descends.

    Incomplete branches (internal nodes with fewer than k children —
    ORBvoc has a few) are padded by duplicating the parent descriptor
    with weight 0; descent through a padded child terminates in a
    zero-weight word, matching DBoW2's behavior of never visiting
    non-existent children."""
    with open(path) as f:
        head = f.readline().split()
        k, L = int(head[0]), int(head[1])
        parents, weights = [], []
        for line in f:
            parts = line.split()
            if len(parts) < 2 + 32 + 1:
                continue
            parents.append(int(parts[0]))
            weights.append(float(parts[-1]))
    raw = np.loadtxt(path, skiprows=1,
                     usecols=range(2, 34), dtype=np.uint8, ndmin=2)
    desc_all = np.ascontiguousarray(raw).view(np.uint32)  # [n, 8]
    parents = np.asarray(parents, np.int64)
    weights = np.asarray(weights, np.float32)
    return _dense_from_tree(k, L, parents, weights, desc_all)


def _dense_from_tree(k: int, L: int, parents: np.ndarray,
                     weights: np.ndarray, desc_all: np.ndarray) -> Vocabulary:
    """Pack a DBoW2 parent-pointer node list (file node ids 1..n, root 0
    implicit) into the dense level-major layout. Shared by the text and
    binary loaders; see `load_dbow_text` for the padded-branch policy."""
    n = len(parents)
    children: dict[int, list[int]] = {}
    for i in range(n):
        children.setdefault(int(parents[i]), []).append(i + 1)  # ids 1..n

    n_nodes = k * (k ** L - 1) // (k - 1)
    node_desc = np.zeros((n_nodes, 8), np.uint32)
    idf = np.zeros(k ** L, np.float32)

    def place(file_id: int, level: int, pos: int):
        """Recursively place file node at (level, pos) of the dense tree."""
        start = k * (k ** (level - 1) - 1) // (k - 1)
        node_desc[start + pos] = desc_all[file_id - 1]
        if level == L:
            idf[pos] = weights[file_id - 1]
            return
        kids = children.get(file_id, [])
        for c, kid in enumerate(kids[:k]):
            place(kid, level + 1, pos * k + c)
        # Pad missing children with the FIRST REAL SIBLING's descriptor:
        # the descent's argmin takes the first index on ties and real
        # children sit before padded ones, so a padded child can never
        # win — exactly DBoW2's "never visit non-existent children"
        # (padding with the PARENT's descriptor could out-score every
        # real child and silently drop the word into a zero-weight leaf).
        pad_d = desc_all[kids[0] - 1] if kids else desc_all[file_id - 1]
        for c in range(len(kids), k):
            _pad(level + 1, pos * k + c, pad_d)

    def _pad(level: int, pos: int, d):
        start = k * (k ** (level - 1) - 1) // (k - 1)
        node_desc[start + pos] = d
        if level == L:
            idf[pos] = 0.0
            return
        for c in range(k):
            _pad(level + 1, pos * k + c, d)

    roots = children.get(0, [])
    for c, kid in enumerate(roots[:k]):
        place(kid, 1, c)
    root_pad = desc_all[roots[0] - 1] if roots else np.zeros(8, np.uint32)
    for c in range(len(roots), k):
        _pad(1, c, root_pad)
    return Vocabulary(k=k, L=L, node_desc=node_desc, idf=idf)


# ---------------------------------------------------------------------------
# ORBvoc.bin binary-format interop (TemplatedVocabulary.h:1275
# loadFromBinaryFile / :1360 saveToBinaryFile): header of uint32
# {nb_nodes, size_node} + int32 {k, L, scoring, weighting}, then one
# packed 41-byte record per non-root node in file-id order:
#   int32 parent | 32-byte descriptor | float32 weight | bool is_leaf
# ---------------------------------------------------------------------------

_BIN_NODE_BYTES = 4 + 32 + 4 + 1


def load_vocabulary(path: str) -> Vocabulary:
    """Load a pretrained DBoW2 vocabulary, dispatching on extension the
    way the reference's System bootstrap does (src/System.cc: .bin ->
    loadFromBinaryFile, else loadFromTextFile)."""
    if path.endswith(".bin"):
        return load_dbow_binary(path)
    return load_dbow_text(path)


def load_dbow_binary(path: str) -> Vocabulary:
    """Load an ORBvoc.bin vocabulary (the reference ships/loads this when
    the path ends in .bin — System.cc vocabulary bootstrap)."""
    with open(path, "rb") as f:
        nb_nodes, size_node = np.fromfile(f, np.uint32, 2)
        k, L, _scoring, _weighting = np.fromfile(f, np.int32, 4)
        if size_node != _BIN_NODE_BYTES or not (0 < k <= 20) \
                or not (1 <= L <= 10):
            raise ValueError(
                f"not a DBoW2 binary vocabulary: size_node={size_node}, "
                f"k={k}, L={L}")
        raw = np.fromfile(f, np.uint8)
    n = int(nb_nodes) - 1             # records exclude the implicit root
    raw = raw[: n * _BIN_NODE_BYTES].reshape(n, _BIN_NODE_BYTES)
    parents = raw[:, :4].copy().view(np.int32).reshape(-1).astype(np.int64)
    desc_all = np.ascontiguousarray(raw[:, 4:36]).view(np.uint32)
    weights = raw[:, 36:40].copy().view(np.float32).reshape(-1)
    return _dense_from_tree(int(k), int(L), parents, weights, desc_all)


def save_dbow_binary(voc: Vocabulary, path: str):
    """Write the vocabulary in DBoW2's binary format (level-major order,
    parents before children, little-endian packed records)."""
    k, L = voc.k, voc.L
    n_nodes = k * (k ** L - 1) // (k - 1)
    rec = np.zeros((n_nodes, _BIN_NODE_BYTES), np.uint8)
    row = 0
    for lv in range(1, L + 1):
        start, end = voc.level_slice(lv)
        pstart = voc.level_slice(lv - 1)[0] if lv > 1 else None
        for i in range(start, end):
            within = i - start
            pid = 0 if lv == 1 else pstart + within // k + 1
            rec[row, :4] = np.frombuffer(
                np.int32(pid).tobytes(), np.uint8)
            rec[row, 4:36] = np.frombuffer(
                voc.node_desc[i].tobytes(), np.uint8)
            w = float(voc.idf[within]) if lv == L else 0.0
            rec[row, 36:40] = np.frombuffer(
                np.float32(w).tobytes(), np.uint8)
            rec[row, 40] = np.uint8(lv == L)
            row += 1
    with open(path, "wb") as f:
        np.asarray([n_nodes + 1, _BIN_NODE_BYTES], np.uint32).tofile(f)
        np.asarray([k, L, 0, 0], np.int32).tofile(f)
        rec.tofile(f)
