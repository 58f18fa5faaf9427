"""Bag-of-words place recognition: vocabulary tree + scoring.

JAX-native replacement for DBoW2 (`Thirdparty/DBoW2`, SURVEY.md §1 layer 3)
and the KeyFrameDatabase inverted index (``src/KeyFrameDatabase.cc``).

Design (SURVEY.md §7 "DBoW2 -> on-device quantization"):
* The vocabulary is a flat per-level centroid table: level ``l`` holds
  ``k^(l+1)`` binary centroids; the children of node ``n`` occupy slots
  ``n*k .. n*k+k-1`` of the next level.  Descent is ``L`` batched
  Hamming-argmin steps (bf16 bit-matmuls) — no pointers, no recursion.
* A keyframe's BoW vector is a dense tf-idf array over the ``k^L`` leaves
  (L1-normalized).  With 10k leaves and bf16 this is 20 KB/KF — dense
  storage beats an inverted index on an accelerator because scoring all
  keyframes at once is one [K, W] elementwise reduction.
* ``detect_candidates`` reproduces DetectNBestCandidates semantics: shared
  word-count gating at 0.8x the best, L1 similarity score, exclusion of
  covisibility-connected keyframes, and the loop/merge split by map id.

The vocabulary is trained with hierarchical k-majority (binary k-means)
over sample descriptors (numpy, offline/startup) — the DBoW2 ORB vocab
file's exact clusters are not required for parity, only candidate quality.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    """Flat vocabulary tree; a pytree.

    levels[l]: [k^(l+1), 32] PACKED u8 centroids (the complete-tree slot
    layout: children of node n at slots n*k..n*k+k-1).  Packed storage is
    what lets the reference-scale ~1M-leaf ORB vocabulary fit on device
    (~35 MB total vs ~570 MB unpacked bf16); descent unpacks only the k
    gathered children per descriptor.

    ``leaf_map`` (imported vocabularies): leaf slot -> word id.  DBoW2
    trees are incomplete (k-means splits stop early on small clusters);
    imported trees pad missing children with sibling copies and remap the
    padded leaf slots onto the real word ids.  None = identity (trained
    complete trees).
    """

    centroid_bits: tuple          # per-level packed [_, 32] u8
    idf: jnp.ndarray              # [n_words] f32
    k: int
    depth: int
    leaf_map: object = None       # None or [k^depth] i32

    @property
    def n_leaves(self) -> int:
        return self.k ** self.depth

    @property
    def n_words(self) -> int:
        return int(self.idf.shape[0])


def _unpack_bits_np(desc: np.ndarray) -> np.ndarray:
    return np.unpackbits(desc, axis=-1, bitorder="little").astype(np.uint8)


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, axis=-1, bitorder="little")


def _kmajority(bits: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """Binary k-means (majority-vote centroids) on [N, 256] 0/1 arrays.
    Returns [k, 256] centroids."""
    n = bits.shape[0]
    if n == 0:
        return rng.integers(0, 2, (k, 256)).astype(np.uint8)
    init = rng.choice(n, size=min(k, n), replace=False)
    cent = bits[init].astype(np.uint8)
    if len(init) < k:
        cent = np.concatenate(
            [cent, rng.integers(0, 2, (k - len(init), 256)).astype(np.uint8)])
    for _ in range(iters):
        # Hamming distance via float matmul on unpacked bits
        d = (bits.astype(np.float32) @ (1 - 2 * cent.astype(np.float32)).T
             + cent.sum(axis=1)[None, :])
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = bits[assign == c]
            if len(sel) == 0:
                cent[c] = bits[rng.integers(0, n)]
            else:
                cent[c] = (sel.mean(axis=0) >= 0.5).astype(np.uint8)
    return cent


_NATIVE_LIB = None


def _load_native():
    """ctypes handle to native/libvocab.so (built by native/build.sh)."""
    global _NATIVE_LIB
    if _NATIVE_LIB is not None:
        return _NATIVE_LIB or None
    import ctypes
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libvocab.so")
    try:
        lib = ctypes.CDLL(os.path.abspath(path))
        lib.build_vocab.restype = ctypes.c_int
        lib.build_vocab.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
        _NATIVE_LIB = lib
    except OSError:
        _NATIVE_LIB = False
        return None
    return _NATIVE_LIB


def _build_vocabulary_native(descs: np.ndarray, k: int, depth: int,
                             iters: int, seed: int) -> "Vocabulary":
    lib = _load_native()
    n = len(descs)
    total_cents = sum(k ** (lv + 1) for lv in range(depth))
    cents = np.zeros((total_cents, 32), np.uint8)
    leaf = np.zeros(n, np.int32)
    descs = np.ascontiguousarray(descs, np.uint8)
    rc = lib.build_vocab(descs.ctypes.data, n, k, depth, iters, seed,
                         cents.ctypes.data, leaf.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"native build_vocab failed rc={rc}")
    levels = []
    off = 0
    for lv in range(depth):
        cnt = k ** (lv + 1)
        levels.append(jnp.asarray(cents[off:off + cnt]))
        off += cnt
    n_leaves = k ** depth
    counts = np.bincount(leaf, minlength=n_leaves).astype(np.float64)
    idf = np.log(max(n, 1) / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(centroid_bits=tuple(levels), idf=jnp.asarray(idf),
                      k=k, depth=depth)


def build_vocabulary(descs: np.ndarray, k: int = 10, depth: int = 3,
                     iters: int = 4, seed: int = 0,
                     backend: str = "auto") -> Vocabulary:
    """Hierarchical k-majority vocabulary from [N, 32] u8 descriptors.

    idf weights from the training set (DBoW2 TF_IDF weighting).
    ``backend``: "auto" prefers the native C++ trainer (native/vocab.cc,
    ~100x the numpy path at EuRoC scale), falling back to numpy.
    """
    if backend in ("auto", "native") and _load_native() is not None:
        return _build_vocabulary_native(descs, k, depth, iters, seed)
    if backend == "native":
        raise RuntimeError("native vocab library unavailable "
                           "(run native/build.sh)")
    rng = np.random.default_rng(seed)
    bits = _unpack_bits_np(descs)
    n = bits.shape[0]

    levels = []
    assignments = np.zeros(n, np.int64)  # node id at current level
    for lv in range(depth):
        n_parent = k ** lv
        cents = np.zeros((k ** (lv + 1), 256), np.uint8)
        new_assign = np.zeros(n, np.int64)
        for p in range(n_parent):
            sel = assignments == p
            c = _kmajority(bits[sel], k, iters, rng)
            cents[p * k:(p + 1) * k] = c
            if sel.any():
                sub = bits[sel].astype(np.float32)
                d = (sub @ (1 - 2 * c.astype(np.float32)).T
                     + c.sum(axis=1)[None, :])
                new_assign[sel] = p * k + d.argmin(axis=1)
        assignments = new_assign
        levels.append(jnp.asarray(_pack_bits_np(cents)))

    n_leaves = k ** depth
    counts = np.bincount(assignments, minlength=n_leaves).astype(np.float64)
    idf = np.log(max(n, 1) / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(centroid_bits=tuple(levels), idf=jnp.asarray(idf),
                      k=k, depth=depth)


def _unpack_device(packed: jnp.ndarray) -> jnp.ndarray:
    """[..., 32] u8 -> [..., 256] bf16 bits, little-endian bit order."""
    bits = (packed[..., :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    return bits.reshape(*packed.shape[:-1], 256).astype(jnp.bfloat16)


def quantize(voc: Vocabulary, desc_bits: jnp.ndarray) -> jnp.ndarray:
    """[N, 256] bit matrix (0/1, any float dtype) -> [N] word ids.

    L batched Hamming-argmin descents; each step gathers + unpacks only
    the k children of the current node, then one bit-matmul.
    """
    n = desc_bits.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    x = desc_bits.astype(jnp.bfloat16)
    pop_x = jnp.sum(x.astype(jnp.float32), axis=-1)
    for lv in range(voc.depth):
        cents = voc.centroid_bits[lv]              # [k^(lv+1), 32] u8
        child0 = node * voc.k
        idx = child0[:, None] + jnp.arange(voc.k)[None, :]  # [N, k]
        c = _unpack_device(cents[idx])             # [N, k, 256]
        dot = jnp.einsum("nd,nkd->nk", x, c,
                         preferred_element_type=jnp.float32)
        pop_c = jnp.sum(c.astype(jnp.float32), axis=-1)
        d = pop_x[:, None] + pop_c - 2.0 * dot
        node = (child0 + jnp.argmin(d, axis=-1)).astype(jnp.int32)
    if voc.leaf_map is not None:
        node = voc.leaf_map[node]
    return node


def bow_vector(voc: Vocabulary, words: jnp.ndarray,
               valid: jnp.ndarray) -> jnp.ndarray:
    """Word ids [F] (+mask) -> dense L1-normalized tf-idf vector [W]."""
    W = voc.n_words
    tf = jnp.zeros((W,), jnp.float32).at[
        jnp.where(valid, words, 0)].add(jnp.where(valid, 1.0, 0.0))
    v = tf * voc.idf
    return v / jnp.maximum(jnp.sum(jnp.abs(v)), 1e-9)


def l1_scores(query: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity: s = 1 - 0.5 |q - d|_1 for L1-normalized
    vectors.  query [W], db [K, W] -> [K]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(query[None, :] - db), axis=-1)


def shared_word_counts(query_words, query_valid, db_word_mask) -> jnp.ndarray:
    """Count of query words present in each db keyframe's word set.
    db_word_mask [K, W] bool (word presence)."""
    W = db_word_mask.shape[1]
    q_mask = jnp.zeros((W,), jnp.float32).at[
        jnp.where(query_valid, query_words, 0)].add(
        jnp.where(query_valid, 1.0, 0.0)) > 0
    return jnp.sum(db_word_mask & q_mask[None, :], axis=-1)


def detect_candidates(scores: jnp.ndarray, shared: jnp.ndarray,
                      eligible: jnp.ndarray, same_map: jnp.ndarray,
                      n_best: int = 3):
    """DetectNBestCandidates: gate by shared-words >= 0.8 * max, then take
    the n_best scoring candidates separately among same-map (loop) and
    other-map (merge) keyframes.

    Returns (loop_idx [n], loop_ok [n], merge_idx [n], merge_ok [n]).
    """
    max_common = jnp.max(jnp.where(eligible, shared, 0))
    gate = eligible & (shared >= 0.8 * max_common) & (shared > 0)
    s = jnp.where(gate, scores, -jnp.inf)
    s_loop = jnp.where(same_map, s, -jnp.inf)
    s_merge = jnp.where(~same_map, s, -jnp.inf)
    lv, li = jax.lax.top_k(s_loop, n_best)
    mv, mi = jax.lax.top_k(s_merge, n_best)
    return (li.astype(jnp.int32), jnp.isfinite(lv),
            mi.astype(jnp.int32), jnp.isfinite(mv))


def synthesize_vocabulary(k: int = 10, depth: int = 6,
                          seed: int = 0) -> Vocabulary:
    """Synthesize a structurally-coherent k^depth-leaf vocabulary (the
    reference regime: ORBvoc is a 10^6-leaf k=10/L=6 DBoW2 tree loaded at
    startup, src/MultiAgentSystem.cc:22-30).  Children perturb their
    parent's centroid with a depth-decaying bit-flip rate, so greedy
    descent is stable (a descriptor near a leaf is near its ancestors) —
    adequate for quantization latency / device-memory measurement and for
    runs without a trained vocabulary file.  ~36 MB packed at 1M leaves."""
    rng = np.random.default_rng(seed)
    levels = []
    parent_bits = rng.integers(0, 2, (1, 256), dtype=np.uint8)
    for lv in range(depth):
        n_children = k ** (lv + 1)
        rep = np.repeat(parent_bits, k, axis=0)            # [k^(lv+1), 256]
        flip_rate = 0.25 / (1.6 ** lv)
        flips = rng.random((n_children, 256)) < flip_rate
        bits = (rep ^ flips).astype(np.uint8)
        levels.append(jnp.asarray(_pack_bits_np(bits)))
        parent_bits = bits
    idf = jnp.ones((k ** depth,), jnp.float32)
    return Vocabulary(centroid_bits=tuple(levels), idf=idf, k=k,
                      depth=depth)


_DEFAULT_VOC = None


def default_vocabulary():
    """The vocabulary used when callers pass none: $MAM3_VOCAB (an
    ORBvoc.txt-format file) if set, else ``data/ORBvoc.txt`` in the repo
    if present, else None (the server then trains a bootstrap vocabulary
    from the stream).  Cached per process."""
    global _DEFAULT_VOC
    import os
    cand = os.environ.get("MAM3_VOCAB") or os.path.join(
        os.path.dirname(__file__), "..", "..", "data", "ORBvoc.txt")
    # cache keyed on the resolved path — a MAM3_VOCAB set (or the file
    # appearing) after a miss is picked up by the next lookup instead of
    # being shadowed by a process-lifetime negative cache
    if isinstance(_DEFAULT_VOC, tuple) and _DEFAULT_VOC[0] == cand:
        return _DEFAULT_VOC[1]
    if cand and os.path.exists(cand):
        _DEFAULT_VOC = (cand, load_orbvoc_text(cand))
        return _DEFAULT_VOC[1]
    return None


@functools.partial(jax.jit, static_argnames=("n_out", "n_group"))
def detect_candidates_grouped(scores: jnp.ndarray, shared: jnp.ndarray,
                              eligible: jnp.ndarray, covis: jnp.ndarray,
                              n_out: int = 9, n_group: int = 10):
    """Covisibility-group accumulated candidate detection — the
    reference's DetectNBestCandidates core
    (/root/reference/src/KeyFrameDatabase.cc:604-730, consumed at
    src/LoopClosing.cc:668):

    * candidates sharing words with the query, gated at >= 0.8 * max
      common words, get their raw L1 score;
    * each gated candidate accumulates the scores of its top-``n_group``
      covisible neighbors that also share words (isolated single-KF hits
      on repetitive texture do NOT outrank a consistently-seen region);
    * each group is represented by its best-scoring member;
    * groups below 0.75 * best accumulated score are rejected.

    Returns (best_kf [n_out], acc [n_out], ok [n_out]) ranked by
    accumulated score; the caller dedupes representatives and splits
    loop/merge by map id (the reference does the same on the host side of
    the scoring).  ``covis`` is the [K, K] weight matrix.
    """
    n_group = min(n_group, covis.shape[0])  # tiny arenas
    n_out = min(n_out, covis.shape[0])
    sharing = eligible & (shared > 0)
    max_common = jnp.max(jnp.where(sharing, shared, 0))
    scored = sharing & (shared.astype(jnp.float32)
                        > 0.8 * max_common.astype(jnp.float32))
    s = jnp.where(scored, scores, 0.0)

    nb_w, nb_idx = jax.lax.top_k(covis, n_group)           # [K, n_group]
    nb_ok = nb_w > 0
    nb_sharing = sharing[nb_idx] & nb_ok
    # accumulate over group members that share words (their score is 0
    # unless they also passed the common-word gate — the reference reads
    # mPlaceRecognitionScore which is only written for gated members)
    acc = s + jnp.sum(jnp.where(nb_sharing, s[nb_idx], 0.0), axis=1)
    acc = jnp.where(scored, acc, -jnp.inf)
    # best-scoring member represents the group
    member_s = jnp.concatenate([scores[:, None],
                                jnp.where(nb_sharing & scored[nb_idx],
                                          scores[nb_idx], -jnp.inf)],
                               axis=1)                     # [K, 1+n_group]
    best_m = jnp.argmax(member_s, axis=1)
    best_kf = jnp.where(best_m == 0, jnp.arange(covis.shape[0]),
                        nb_idx[jnp.arange(covis.shape[0]),
                               jnp.clip(best_m - 1, 0)])
    best_acc = jnp.max(acc)
    ok_thresh = acc >= 0.75 * best_acc
    ranked_acc, ranked = jax.lax.top_k(jnp.where(ok_thresh, acc, -jnp.inf),
                                       n_out)
    return (best_kf[ranked].astype(jnp.int32), ranked_acc,
            jnp.isfinite(ranked_acc))


# ---------------------------------------------------------------------------
# sparse BoW database rows (reference-scale vocabularies)
# ---------------------------------------------------------------------------
# A keyframe touches at most F words, so its tf-idf vector has <= F nonzeros
# regardless of vocabulary size.  The database stores (word ids, values)
# per KF; scoring all K keyframes against a query is one gather + reduction
# — O(K*F), independent of W.  (The reference's DBoW2 inverted file solves
# the same scaling problem on CPU; gathers are the device idiom for it.)

def sparse_bow_row(voc: Vocabulary, words_np: np.ndarray,
                   valid_np: np.ndarray, cap: int):
    """Host-side: word ids [F] + mask -> (uniq_words [cap] i32 padded -1,
    vals [cap] f32, L1-normalized tf-idf)."""
    uw, counts = np.unique(words_np[valid_np], return_counts=True)
    idf = np.asarray(voc.idf)
    vals = counts.astype(np.float32) * idf[uw]
    s = np.abs(vals).sum()
    if s > 1e-9:
        vals = vals / s
    out_w = np.full(cap, -1, np.int32)
    out_v = np.zeros(cap, np.float32)
    n = min(len(uw), cap)
    out_w[:n] = uw[:n]
    out_v[:n] = vals[:n]
    return out_w, out_v


def dense_query(voc: Vocabulary, q_words: np.ndarray,
                q_vals: np.ndarray) -> np.ndarray:
    """Sparse query row -> dense [W] f32 (host scatter; 4 MB at W=1e6)."""
    q = np.zeros(voc.n_words, np.float32)
    sel = q_words >= 0
    q[q_words[sel]] = q_vals[sel]
    return q


@jax.jit
def l1_scores_sparse(q_dense: jnp.ndarray, db_words: jnp.ndarray,
                     db_vals: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity against every db row at once.  For
    L1-normalized non-negative vectors, 1 - 0.5|q-d|_1 = sum_w min(q,d),
    which only needs the db rows' own word slots.  q_dense [W],
    db_words [K, F] (-1 pad), db_vals [K, F] -> [K]."""
    at = q_dense[jnp.clip(db_words, 0)]
    return jnp.sum(jnp.where(db_words >= 0,
                             jnp.minimum(at, db_vals), 0.0), axis=-1)


@jax.jit
def shared_words_sparse(q_dense: jnp.ndarray,
                        db_words: jnp.ndarray) -> jnp.ndarray:
    """Count of query words present in each db row's word set."""
    present = q_dense[jnp.clip(db_words, 0)] > 0
    return jnp.sum(jnp.where(db_words >= 0, present, False), axis=-1)


# ---------------------------------------------------------------------------
# DBoW2 ORBvoc.txt import / export
# ---------------------------------------------------------------------------

def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse a DBoW2 text vocabulary (the reference's ORBvoc.txt format,
    loaded by ORBVocabulary::loadFromTextFile in
    /root/reference/src/MultiAgentSystem.cc:22-30).

    Format: header ``k L scoring weighting``; one line per node (breadth
    order): ``parentId isLeaf b0 .. b31 weight``.  Node ids are implicit
    (1 + line index; node 0 is the root).  Word ids are assigned to leaves
    in file order (DBoW2 createWords()).

    DBoW2 trees are incomplete; missing child slots of the complete k-ary
    layout are padded with a sibling copy, and early leaves (a leaf above
    the bottom level) propagate their centroid down so every descent ends
    at the bottom; ``leaf_map`` folds the padded bottom slots back onto
    real word ids.
    """
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(int(parts[1]))
            descs.append([int(v) for v in parts[2:34]])
            weights.append(float(parts[34]))
    n_nodes = len(parents)
    parents = np.asarray(parents, np.int64)
    is_leaf = np.asarray(leaves, bool)
    descs = np.asarray(descs, np.uint8)
    weights = np.asarray(weights, np.float64)

    # node id in the file = 1 + line index (root = 0, no line)
    # slot[level][complete-tree index] assignment
    levels = [np.zeros((k ** (lv + 1), 32), np.uint8) for lv in range(L)]
    # word ids in file order of leaves
    word_of_node = np.full(n_nodes + 1, -1, np.int64)
    word_of_node[1:][is_leaf] = np.arange(int(is_leaf.sum()))
    idf = weights[is_leaf].astype(np.float32)

    node_level = np.full(n_nodes + 1, -1, np.int64)   # depth of each node
    node_slot = np.full(n_nodes + 1, -1, np.int64)    # complete-tree slot
    node_level[0] = -1
    node_slot[0] = 0
    child_count = np.zeros(n_nodes + 1, np.int64)
    leaf_map = np.full(k ** L, 0, np.int64)

    # nodes appear after their parent in the file (breadth order)
    pending_fill = []   # (level, slot, packed desc, word) subtrees to fill
    for i in range(n_nodes):
        nid = i + 1
        p = parents[i]
        lv = node_level[p] + 1
        ci = child_count[p]
        if ci >= k:
            raise ValueError(f"node {nid}: parent {p} has > k children")
        child_count[p] += 1
        slot = node_slot[p] * k + ci
        node_level[nid] = lv
        node_slot[nid] = slot
        levels[lv][slot] = descs[i]
        if is_leaf[i]:
            pending_fill.append((lv, slot, descs[i], word_of_node[nid]))

    # pad missing children with a copy of the group's FIRST filled sibling
    # (children are allocated as a prefix of each group, so the copy sits
    # after the original and can never win an exact-tie argmin against it
    # — a descent never lands on a padded slot)
    for lv in range(L):
        cnt = k ** (lv + 1)
        filled = np.zeros(cnt, bool)
        sel = node_level[1:] == lv
        filled[node_slot[1:][sel]] = True
        groups = filled.reshape(-1, k)
        first = groups.argmax(axis=1)
        has = groups.any(axis=1)
        src_full = np.repeat(np.arange(cnt // k) * k + first, k)
        need = ~filled & np.repeat(has, k)
        levels[lv][need] = levels[lv][src_full[need]]

    # propagate early leaves down to the bottom level and build leaf_map
    bottom_filled = np.zeros(k ** L, bool)
    for lv, slot, d, w in pending_fill:
        lo, hi = slot, slot + 1
        for l2 in range(lv + 1, L):
            lo, hi = lo * k, hi * k
            levels[l2][lo:hi] = d
        leaf_map[lo:hi] = w
        bottom_filled[lo:hi] = True
    # padded bottom slots inherit their group's first real word
    groups = bottom_filled.reshape(-1, k)
    first = groups.argmax(axis=1)
    has = groups.any(axis=1)
    src_full = np.repeat(np.arange(k ** (L - 1)) * k + first, k)
    need = ~bottom_filled & np.repeat(has, k)
    leaf_map[need] = leaf_map[src_full[need]]

    return Vocabulary(
        centroid_bits=tuple(jnp.asarray(lv_arr) for lv_arr in levels),
        idf=jnp.asarray(idf), k=k, depth=L,
        leaf_map=jnp.asarray(leaf_map, jnp.int32))


def save_orbvoc_text(voc: Vocabulary, path: str) -> None:
    """Export a (trained, complete-tree) vocabulary in the DBoW2 text
    format so it round-trips through load_orbvoc_text and is consumable
    by reference tooling."""
    if voc.leaf_map is not None:
        raise ValueError("export of imported (remapped) vocabularies is "
                         "not supported")
    k, L = voc.k, voc.depth
    idf = np.asarray(voc.idf)
    lines = [f"{k} {L} 0 0"]
    # breadth order; node ids: root=0, then level by level
    level_base = [1]
    for lv in range(L - 1):
        level_base.append(level_base[-1] + k ** (lv + 1))
    for lv in range(L):
        cents = np.asarray(voc.centroid_bits[lv])
        for s in range(k ** (lv + 1)):
            parent = 0 if lv == 0 else level_base[lv - 1] + s // k
            leaf = 1 if lv == L - 1 else 0
            w = float(idf[s]) if leaf else 0.0
            b = " ".join(str(int(v)) for v in cents[s])
            lines.append(f"{parent} {leaf} {b} {w:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
