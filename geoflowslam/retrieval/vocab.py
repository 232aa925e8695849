"""Bag-of-binary-words vocabulary: build, descend, score — batched.

JAX replacement for DBoW2's TemplatedVocabulary<FORB>
(/root/reference/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h): the k-ary
tree descent over 256-bit ORB descriptors becomes a per-level batched
Hamming argmin (one [N, k] distance tile per level via the same matmul popcount
matmul as ops/matching.py), and BoW vectors are dense [V] tf-idf histograms
so similarity scoring (DBoW2 L1 score) and database queries are single
vectorized reductions.

The reference ships a 1M-word vocabulary trained on real images
(Vocabulary/ORBvoc.txt); our descriptors use a different (generated) BRIEF
pattern, so the vocabulary is trained from descriptors of the target domain
with `build_vocabulary` (hierarchical k-medians with bitwise majority vote,
the binary-descriptor k-means of the DBoW2 paper). V = k^L words (default
10^3..10^4) is plenty for loop retrieval at our map scales.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from geoflowslam.ops.matching import hamming_matrix


class Vocabulary(NamedTuple):
    """Complete k-ary tree of depth L; nodes stored per level."""
    centers: tuple          # per level l: [k^(l+1), 8] uint32 node centers
    weights: jnp.ndarray    # [V] idf word weights
    k: int
    levels: int

    @property
    def n_words(self):
        return self.k ** self.levels


def _popcount_np(x):
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(-1)


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid of [N, 8] uint32 descriptors."""
    bits = np.unpackbits(np.ascontiguousarray(desc).view(np.uint8), axis=-1)
    maj = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians_binary(desc: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """Binary k-means (majority-vote centers, Hamming assignment)."""
    n = len(desc)
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    centers = desc[rng.choice(n, size=min(k, n), replace=False)]
    if len(centers) < k:
        centers = np.concatenate(
            [centers, centers[rng.choice(len(centers), k - len(centers))]])
    for _ in range(iters):
        d = _popcount_np(desc[:, None, :] ^ centers[None, :, :])
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = desc[assign == c]
            if len(sel):
                centers[c] = _majority_center(sel)
    return centers.astype(np.uint32)


def build_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     iters: int = 6, seed: int = 0) -> Vocabulary:
    """Hierarchical k-medians over [N, 8] uint32 descriptors (host-side,
    offline — like DBoW2's create())."""
    rng = np.random.RandomState(seed)
    desc = np.asarray(descriptors, np.uint32)
    level_centers = []
    # node assignment of each descriptor at the current level
    assign = np.zeros(len(desc), np.int64)
    n_nodes = 1
    for lvl in range(levels):
        centers = np.zeros((n_nodes * k, 8), np.uint32)
        new_assign = np.zeros_like(assign)
        for node in range(n_nodes):
            sel = assign == node
            c = _kmedians_binary(desc[sel], k, iters, rng)
            centers[node * k:(node + 1) * k] = c
            if sel.any():
                d = _popcount_np(desc[sel][:, None, :] ^ c[None, :, :])
                new_assign[sel] = node * k + d.argmin(axis=1)
        level_centers.append(jnp.asarray(centers))
        assign = new_assign
        n_nodes *= k
    # idf weights from training distribution
    v = n_nodes
    counts = np.bincount(assign, minlength=v).astype(np.float64)
    n_im = max(len(desc) / 500.0, 1.0)  # pseudo-documents
    idf = np.log(n_im / np.maximum(counts / 500.0, 1e-3))
    idf = np.maximum(idf, 0.0) + 1e-3
    return Vocabulary(centers=tuple(level_centers),
                      weights=jnp.asarray(idf, jnp.float32), k=k, levels=levels)


def load_dbow2_text(path: str, max_levels: int | None = None) -> Vocabulary:
    """Load a DBoW2 text vocabulary (the reference's ORBvoc.txt format:
    header `k L scoring weighting`, then one node per line
    `parent is_leaf d0..d31 weight`, TemplatedVocabulary::loadFromTextFile).

    The DBoW2 tree can be incomplete; missing children are padded with their
    parent's centre (they then never win an argmin over real siblings except
    on ties, preserving descent behaviour). Note: ORBvoc.txt was trained on
    OpenCV-pattern ORB descriptors — use it only with descriptor sources
    matching that pattern; vocabularies for this framework's generated BRIEF
    pattern come from `build_vocabulary`.
    """
    with open(path) as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        if max_levels is not None:
            levels = min(levels, max_levels)
        children = {}      # parent id -> child node ids
        rows = []
        for i, line in enumerate(f):
            parts = line.split()
            if len(parts) < 35:
                continue
            node_id = i + 1            # ids are implicit; 0 is the root
            parent = int(parts[0])
            desc = np.frombuffer(
                bytes(int(x) for x in parts[2:34]), dtype=np.uint32).copy()
            weight = float(parts[34]) if len(parts) > 34 else 1.0
            rows.append((node_id, parent, desc, weight))
            children.setdefault(parent, []).append(node_id)

    id2desc = {nid: d for nid, _, d, _ in rows}
    id2w = {nid: w for nid, _, _, w in rows}
    # build padded complete tree level by level (BFS from root id -1's kids)
    level_centers = []
    # DBoW2 roots: children of node 0? In the text format the first k nodes
    # have parent 0; node ids are implicit order. Treat parent==0 nodes as
    # level-1.
    frontier = [nid for nid, par, _, _ in rows if par == 0][:k]
    slot_nodes = frontier + [None] * (k - len(frontier))
    for lvl in range(levels):
        centers = np.zeros((k ** (lvl + 1), 8), np.uint32)
        next_nodes = []
        for si, nid in enumerate(slot_nodes):
            if nid is not None and nid in id2desc:
                centers[si] = id2desc[nid]
            elif si > 0:
                centers[si] = centers[(si // k) * k]  # pad with first sibling
            kids = children.get(nid, []) if nid is not None else []
            kids = kids[:k] + [None] * (k - min(len(kids), k))
            # missing children inherit the parent node id for padding lookups
            kids = [c if c is not None else nid for c in kids]
            next_nodes.extend(kids)
        level_centers.append(jnp.asarray(centers))
        if lvl == levels - 1:
            last_nodes = slot_nodes
        slot_nodes = next_nodes
    v = k ** levels
    # word weights: each last-level slot descends from some stored node
    # (leaves at shallower depth propagate via the parent-id padding above);
    # take that node's stored idf weight (TemplatedVocabulary leaf weights)
    weights = np.array([id2w.get(nid, 1.0) if nid is not None else 0.0
                        for nid in last_nodes], np.float32)
    if not np.any(weights > 0):
        weights = np.ones((v,), np.float32)
    return Vocabulary(centers=tuple(level_centers),
                      weights=jnp.asarray(weights), k=k, levels=levels)


def save_vocabulary(path: str, vocab: Vocabulary):
    """Persist a vocabulary as npz (this build's ORBvoc.txt analogue)."""
    arrs = {f"centers_{i}": np.asarray(c) for i, c in enumerate(vocab.centers)}
    np.savez_compressed(path, k=vocab.k, levels=vocab.levels,
                        weights=np.asarray(vocab.weights), **arrs)


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    levels = int(z["levels"])
    centers = tuple(jnp.asarray(z[f"centers_{i}"]) for i in range(levels))
    return Vocabulary(centers=centers, weights=jnp.asarray(z["weights"]),
                      k=int(z["k"]), levels=levels)


_DEFAULT_VOCAB = None


def default_vocabulary() -> Vocabulary:
    """The shipped vocabulary artifact trained with `build_vocabulary` on
    descriptors from this framework's own (generated-pattern) ORB extractor
    over varied synthetic scenes — the drop-in replacement for the
    reference's bundled ORBvoc (see tools/train_vocab.py). Cached."""
    global _DEFAULT_VOCAB
    if _DEFAULT_VOCAB is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "..", "assets",
                            "vocab_default.npz")
        _DEFAULT_VOCAB = load_vocabulary(path)
    return _DEFAULT_VOCAB


def descend(vocab: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray):
    """[N,8]u32 -> word ids [N] int32 (batched tree descent)."""
    n = desc.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    for lvl in range(vocab.levels):
        centers = vocab.centers[lvl]                 # [n_nodes*k, 8]
        # children of `node` are node*k ... node*k+k-1
        child_ids = node[:, None] * vocab.k + jnp.arange(vocab.k)[None, :]
        child_desc = centers[child_ids]              # [N, k, 8]
        d = hamming_batch(desc, child_desc)          # [N, k]
        node = (node * vocab.k + jnp.argmin(d, axis=1)).astype(jnp.int32)
    return jnp.where(valid, node, -1)


def hamming_batch(desc: jnp.ndarray, centers: jnp.ndarray) -> jnp.ndarray:
    """[N,8] vs [N,k,8] -> [N,k] Hamming via popcount (elementwise XOR)."""
    x = desc[:, None, :] ^ centers
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def bow_vector(vocab: Vocabulary, word_ids: jnp.ndarray) -> jnp.ndarray:
    """Dense tf-idf L1-normalized BoW vector [V]."""
    v = vocab.n_words
    ok = word_ids >= 0
    tgt = jnp.where(ok, word_ids, v)
    hist = jnp.zeros((v,), jnp.float32).at[tgt].add(1.0, mode="drop")
    w = hist * vocab.weights
    return w / jnp.maximum(jnp.sum(w), 1e-9)


def l1_score(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity: 1 - 0.5 |a - b|_1 = sum min(a_i, b_i) for
    L1-normalized vectors (ScoringObject.cc). Supports batched `a`."""
    return jnp.sum(jnp.minimum(a, b), axis=-1)
