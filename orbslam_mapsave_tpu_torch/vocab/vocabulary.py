"""Hierarchical ORB vocabulary as dense arrays (DBoW2 rebuilt for batches).

Port of `orbslam_mapsave_tpu/vocab/vocabulary.py` (`TemplatedVocabulary`,
`Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h`): nodes as flat arrays
(packed descriptor (Nn,32) u8, parent, children table (Nn,k), weight, leaf
word id); the fork's binary and text file formats; `train` by hierarchical
binary k-medians; the tree descent for all descriptors of a keyframe at
once (`make_transform_packed`, and `make_transform` for bit-plane input);
sparse and dense L1-normalized tf-idf BoW vectors and the DBoW2 L1 score;
the ORBvoc-scale `synthetic_full` fixture. The file formats, `train` and
`synthetic_full` are numpy and byte-identical to the JAX version's.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np
import torch

DESC_BYTES = 32  # FORB::L
_PAD = int(np.iinfo(np.int32).max)  # sparse-row pad (keeps rows sorted)
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


@dataclasses.dataclass
class Vocabulary:
    k: int
    L: int
    scoring: int  # 0 = L1 (the fork uses L1, TemplatedVocabulary.h:484)
    weighting: int  # 0 = TF_IDF
    parent: np.ndarray  # (Nn,) i32; parent[0] = -1
    children: np.ndarray  # (Nn,k) i32, -1 pad
    desc: np.ndarray  # (Nn,32) u8
    weight: np.ndarray  # (Nn,) f32 (leaf idf weights)
    word_id: np.ndarray  # (Nn,) i32 leaf -> word id, -1 for internal
    n_words: int

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0]


# ---------------------------------------------------------------------------
# Binary / text format parity
# ---------------------------------------------------------------------------


def load_binary(path: str | Path) -> Vocabulary:
    """Read the fork's ORBvoc.bin layout (TemplatedVocabulary.h:1467-1517):
    header {u32 nb_nodes, u32 size_node, i32 k, i32 L, i32 scoring, i32
    weighting}, then per node {i32 parent, 32B descriptor, f32 weight, u8
    is_leaf}; node 0 is the implicit root."""
    raw = Path(path).read_bytes()
    nb_nodes, size_node, k, L, scoring, weighting = struct.unpack_from("<IIiiii", raw, 0)
    off = 24
    n_rec = (len(raw) - off) // size_node
    rec = np.frombuffer(raw, dtype=np.uint8, count=n_rec * size_node,
                        offset=off).reshape(n_rec, size_node)
    Nn = n_rec + 1
    parent = np.full(Nn, -1, np.int32)
    parent[1:] = rec[:, 0:4].copy().view("<i4")[:, 0]
    desc = np.zeros((Nn, DESC_BYTES), np.uint8)
    desc[1:] = rec[:, 4:4 + DESC_BYTES]
    weight = np.zeros(Nn, np.float32)
    weight[1:] = rec[:, 4 + DESC_BYTES:8 + DESC_BYTES].copy().view("<f4")[:, 0]
    is_leaf = np.concatenate([[False], rec[:, 8 + DESC_BYTES] != 0])
    word_id = np.full(Nn, -1, np.int32)
    leaf_nodes = np.nonzero(is_leaf)[0]
    word_id[leaf_nodes] = np.arange(len(leaf_nodes), dtype=np.int32)
    return Vocabulary(k, L, scoring, weighting, parent, _children_table(parent, k),
                      desc, weight, word_id, len(leaf_nodes))


def save_binary(path: str | Path, voc: Vocabulary) -> None:
    """Write the fork's binary layout (saveToBinaryFile,
    TemplatedVocabulary.h:1514-1535)."""
    Nn = voc.n_nodes
    size_node = 4 + DESC_BYTES + 4 + 1
    header = struct.pack("<IIiiii", Nn, size_node, voc.k, voc.L, voc.scoring,
                         voc.weighting)
    rec = np.zeros((Nn - 1, size_node), np.uint8)
    rec[:, 0:4] = voc.parent[1:].astype("<i4").view(np.uint8).reshape(-1, 4)
    rec[:, 4:4 + DESC_BYTES] = voc.desc[1:]
    rec[:, 4 + DESC_BYTES:8 + DESC_BYTES] = (
        voc.weight[1:].astype("<f4").view(np.uint8).reshape(-1, 4))
    rec[:, 8 + DESC_BYTES] = (voc.word_id[1:] >= 0).astype(np.uint8)
    with open(Path(path), "wb") as f:
        f.write(header)
        f.write(rec.tobytes())


def load_text(path: str | Path) -> Vocabulary:
    """Text format (loadFromTextFile, TemplatedVocabulary.h:1351-1440):
    header 'k L scoring weighting'; then per node 'parent is_leaf d0..d31 w'."""
    with open(path) as f:
        k, L, scoring, weighting = (int(x) for x in f.readline().split())
        parents, descs, weights, leaves = [-1], [np.zeros(32, np.uint8)], [0.0], [False]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(bool(int(parts[1])))
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))
    parent = np.asarray(parents, np.int32)
    word_id = np.full(len(parent), -1, np.int32)
    leaf_nodes = np.nonzero(np.asarray(leaves))[0]
    word_id[leaf_nodes] = np.arange(len(leaf_nodes), dtype=np.int32)
    return Vocabulary(k, L, scoring, weighting, parent, _children_table(parent, k),
                      np.stack(descs), np.asarray(weights, np.float32), word_id,
                      len(leaf_nodes))


def save_text(path: str | Path, voc: Vocabulary) -> None:
    lines = [f"{voc.k} {voc.L} {voc.scoring} {voc.weighting}"]
    for nid in range(1, voc.n_nodes):
        leaf = 1 if voc.word_id[nid] >= 0 else 0
        ds = " ".join(str(int(b)) for b in voc.desc[nid])
        lines.append(f"{voc.parent[nid]} {leaf} {ds} {voc.weight[nid]:.6f}")
    Path(path).write_text("\n".join(lines) + "\n")


def load(path: str | Path) -> Vocabulary:
    """Suffix-dispatched loader like `System::System` (`src/System.cc:126-140`)."""
    p = str(path)
    return load_binary(p) if p.endswith(".bin") else load_text(p)


def _children_table(parent: np.ndarray, k: int) -> np.ndarray:
    """parent[] -> (Nn, k) child table, -1 pad: a stable sort by parent id
    groups siblings, the lane is the rank within the group."""
    Nn = parent.shape[0]
    kk = max(k, 1)
    children = np.full((Nn, kk), -1, np.int32)
    order = np.argsort(parent, kind="stable")
    ps = parent[order]
    lane = np.arange(Nn) - np.searchsorted(ps, ps, side="left")
    ok = (ps >= 0) & (ps < Nn) & (lane < kk)
    children[ps[ok], lane[ok]] = order[ok].astype(np.int32)
    return children


# ---------------------------------------------------------------------------
# Training (binary hierarchical k-medians)
# ---------------------------------------------------------------------------


def _popcount_u64(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint64 array (numpy's bitwise_count where
    it exists, a byte table otherwise: the same integers)."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    b = np.ascontiguousarray(x).view(np.uint8).reshape(x.shape + (8,))
    return _POP8[b].sum(-1)


def _kmajority(desc_bits: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-means with majority-vote centroids (FORB::meanValue
    analogue). desc_bits: (N,256) uint8 {0,1}. Returns (centroids (k,256),
    assignment (N,)); distances by popcount on packed (N,4) uint64."""
    N = desc_bits.shape[0]
    k = min(k, N)
    packed64 = np.ascontiguousarray(
        np.packbits(desc_bits, axis=1, bitorder="little")).view(np.uint64)
    sel = rng.choice(N, k, replace=False)
    cent_bits = desc_bits[sel].astype(np.uint8)
    assign = np.zeros(N, np.int64)
    for _ in range(iters):
        cent64 = np.ascontiguousarray(
            np.packbits(cent_bits, axis=1, bitorder="little")).view(np.uint64)
        d = _popcount_u64(packed64[:, None, :] ^ cent64[None, :, :]).sum(-1, dtype=np.int32)
        assign = d.argmin(-1)
        for c in range(k):
            m = assign == c
            if m.any():
                cent_bits[c] = (desc_bits[m].mean(0) >= 0.5).astype(np.uint8)
            else:
                cent_bits[c] = desc_bits[rng.integers(N)]
    return cent_bits, assign


def train(descriptors: np.ndarray, k: int = 10, L: int = 3, seed: int = 0) -> Vocabulary:
    """Build a k^L vocabulary from training descriptors (N,32) u8 with
    tf-idf weights (`TemplatedVocabulary::create`; idf over the training
    corpus treated as one document set)."""
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(descriptors, axis=1, bitorder="little")
    parents, descs, levels = [-1], [np.zeros(32, np.uint8)], [0]
    node_members: list[np.ndarray | None] = [None]
    queue = [(0, np.arange(bits.shape[0]))]
    while queue:
        nid, members = queue.pop(0)
        if levels[nid] >= L or len(members) <= k:
            continue
        cent, assign = _kmajority(bits[members], k, rng)
        for c in range(cent.shape[0]):
            sub = members[assign == c]
            if len(sub) == 0:
                continue
            cid = len(parents)
            parents.append(nid)
            descs.append(np.packbits(cent[c], bitorder="little"))
            levels.append(levels[nid] + 1)
            node_members.append(sub)
            queue.append((cid, sub))
    parent = np.asarray(parents, np.int32)
    desc = np.stack(descs)
    Nn = len(parent)
    has_child = np.zeros(Nn, bool)
    has_child[parent[parent >= 0]] = True
    has_child[0] = True
    word_id = np.full(Nn, -1, np.int32)
    leaf_nodes = np.nonzero(~has_child)[0]
    word_id[leaf_nodes] = np.arange(len(leaf_nodes), dtype=np.int32)
    # idf weights ln(N / count), DBoW2's initiate-from-one-document path
    weight = np.zeros(Nn, np.float32)
    for nid in leaf_nodes:
        cnt = len(node_members[nid]) if node_members[nid] is not None else 1
        weight[nid] = max(np.log(bits.shape[0] / max(cnt, 1)), 1e-3)
    return Vocabulary(k, L, 0, 0, parent, _children_table(parent, k), desc,
                      weight, word_id, len(leaf_nodes))


def synthetic_full(k: int = 10, L: int = 6, seed: int = 0) -> Vocabulary:
    """A complete k^L tree with random descriptors — an ORBvoc-SCALE fixture
    (k=10, L=6 -> 1,111,111 nodes / 1M words, the geometry stored in the
    real `ORBvoc.bin` header, `TemplatedVocabulary.h:1471-1476`). The project
    does not ship ORBvoc itself; this gives its shapes, memory and latency
    without the data. The same seed gives the JAX version's tree."""
    counts = [k**i for i in range(L + 1)]
    Nn = sum(counts)
    off = np.concatenate([[0], np.cumsum(counts)])
    parent = np.full(Nn, -1, np.int32)
    for lvl in range(1, L + 1):
        ids = np.arange(counts[lvl])
        parent[off[lvl] + ids] = (off[lvl - 1] + ids // k).astype(np.int32)
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 256, (Nn, DESC_BYTES), dtype=np.uint8)
    desc[0] = 0
    weight = rng.uniform(0.1, 1.0, Nn).astype(np.float32)
    word_id = np.full(Nn, -1, np.int32)
    leaves = np.arange(off[L], Nn)
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
    return Vocabulary(k, L, 0, 0, parent, _children_table(parent, k), desc,
                      weight, word_id, len(leaves))


# ---------------------------------------------------------------------------
# Tree descent + scoring (device path)
# ---------------------------------------------------------------------------


def make_transform_packed(voc: Vocabulary, levelsup: int = 4):
    """Returns transform(desc_u8 (N,32) u8, valid (N,)) -> dict(word (N,),
    weight (N,), node (N,)): the descent of every descriptor from the root,
    one level at a time, to the child at the least Hamming distance (first
    child on ties) until a leaf (`TemplatedVocabulary::transform`,
    `:1180-1260`); `node` is the ancestor at depth L-levelsup (the
    FeatureVector key, `src/KeyFrame.cc:786-788`). Hamming distances are
    byte XORs counted through a 256-entry popcount table. The tables move
    to a tensor's device on first use there."""
    L = voc.L
    node_depth_for_fv = max(L - levelsup, 0)
    tables: dict = {}

    def _tables(dev):
        if dev not in tables:
            tables[dev] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                voc.children, voc.desc, voc.weight, voc.word_id, _POP8))
        return tables[dev]

    def transform(desc_u8: torch.Tensor, valid: torch.Tensor):
        children, child_desc, weight, word_id, pop8 = _tables(desc_u8.device)
        N = desc_u8.shape[0]
        cur = torch.zeros(N, dtype=torch.int64, device=desc_u8.device)
        fv_node = torch.zeros_like(cur)
        for depth in range(L + 1):
            ch = children[cur]  # (N,k)
            has = ch >= 0
            cb = child_desc[torch.clamp(ch, min=0).long()]  # (N,k,32) u8
            x = torch.bitwise_xor(cb, desc_u8[:, None, :])
            d = torch.sum(pop8[x.long()], -1)
            d = torch.where(has, d, torch.full_like(d, 1 << 20))
            best = torch.argmin(d, -1)
            nxt = torch.gather(ch, 1, best[:, None])[:, 0].long()
            cur = torch.where(has.any(-1), nxt, cur)
            if depth + 1 == node_depth_for_fv:
                fv_node = cur
        wid = word_id[cur]
        ok = valid & (wid >= 0)
        return dict(word=torch.where(ok, wid, -1),
                    weight=torch.where(ok, weight[cur], torch.zeros_like(weight[cur])),
                    node=torch.where(ok, fv_node.to(torch.int32), -1))

    return transform


def make_transform(voc: Vocabulary, levelsup: int = 4):
    """`make_transform_packed` for descriptors given as (N,256) int8 bit
    planes (LSB-first, `hamming.unpack_bits`), the JAX version's bit-plane
    entry point. The sum of |child bit - descriptor bit| over the planes is
    the Hamming distance the packed descent counts, so both descend alike;
    here the planes are packed back and the packed descent runs."""
    from ..ops import hamming

    packed = make_transform_packed(voc, levelsup)

    def transform(desc_bits: torch.Tensor, valid: torch.Tensor):
        return packed(hamming.pack_bits(desc_bits), valid)

    return transform


def sparse_bow(word: torch.Tensor, weight: torch.Tensor, m_cap: int):
    """Sparse L1-normalized tf-idf BoW from per-feature (word, weight):
    (words (m_cap,) i32 ascending, INT32_MAX padded; weights (m_cap,) f32, 0
    on pads). Duplicate words sum (`BowVector::addWeight`); the L1 mass is
    normalized to 1. As in the JAX version, runs past the m-th all add into
    the last slot (the run index is clipped). Each slot's contiguous range
    of sorted entries is summed as a difference of a float64 prefix sum
    (order-free, so card runs repeat bit for bit; the JAX version
    scatter-adds in float32)."""
    N = word.shape[0]
    dev = word.device
    ok = word >= 0
    keys = torch.where(ok, word.to(torch.int32), _PAD)
    sw, order = torch.sort(keys, stable=True)
    swt = torch.where(ok, weight, torch.zeros_like(weight))[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sw[1:] != sw[:-1]])
    cs = torch.cumsum(swt.to(torch.float64), 0)
    m = min(m_cap, N)
    pos = torch.arange(N, device=dev)
    slot = torch.clamp(torch.cumsum(first.to(torch.int64), 0) - 1, max=m - 1)
    starts = torch.full((m,), N - 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, slot, pos, reduce="amin")
    ends = torch.zeros(m, dtype=torch.int64, device=dev).scatter_reduce(
        0, slot, pos, reduce="amax")
    before = torch.where(starts > 0, cs[torch.clamp(starts - 1, min=0)],
                         torch.zeros_like(cs[:1]))
    used = torch.arange(m, device=dev) <= slot[-1]
    sums = torch.where(used, (cs[ends] - before).to(torch.float32), 0.0)
    words = sw[starts]
    live = (words != _PAD) & (sums > 0)
    total = torch.sum(torch.where(live, sums, torch.zeros_like(sums)))
    out_w = torch.where(live, sums / torch.clamp(total, min=1e-12), torch.zeros_like(sums))
    out_words = torch.where(live, words, _PAD)
    if m < m_cap:
        out_words = torch.cat([out_words, torch.full((m_cap - m,), _PAD, dtype=torch.int32,
                                                      device=dev)])
        out_w = torch.cat([out_w, torch.zeros(m_cap - m, dtype=out_w.dtype, device=dev)])
    return out_words, out_w


def bow_vector(word: torch.Tensor, weight: torch.Tensor, n_words: int) -> torch.Tensor:
    """Dense L1-normalized tf-idf BoW vector (W,) from per-feature words
    (`BowVector::addWeight` + `normalize(L1)`, `BowVector.cpp:47-81`)."""
    v = torch.zeros(n_words + 1, dtype=torch.float32, device=word.device)
    v = v.index_add(0, torch.where(word >= 0, word, n_words).long(),
                    torch.where(word >= 0, weight, torch.zeros_like(weight)))[:n_words]
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-12)


def score_l1(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score in [0,1] (`L1Scoring::score`, ScoringObject.cpp:23-70)
    for L1-normalized vectors; broadcasts (W,)x(K,W)->(K,)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)
