"""Parity: the port's vocabulary and sparse keyframe database against the JAX
package, on real ORB descriptors (rendered BoxRoom frames at 320x240).
Integer outputs (trees, words, nodes, candidate masks, common-word counts)
must be equal and files byte-identical; float weights and scores agree
within 1e-6 (the port sums a BoW row's duplicate words as a float64 prefix
difference, the JAX package scatter-adds in float32)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.vocab import database as jdb
from orbslam_mapsave_tpu.vocab import vocabulary as jvoc
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.ops import orb as torb
from orbslam_mapsave_tpu_torch.vocab import database as tdb
from orbslam_mapsave_tpu_torch.vocab import vocabulary as tvoc

torch.set_num_threads(2)
W, H = 320, 240
TOL = 1e-6
ARRAYS = ("parent", "children", "desc", "weight", "word_id")


def _descriptors(frames=(0, 3, 6, 9)):
    """ORB descriptors (u8 (n,32)) of rendered frames, one array per frame."""
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1.0]])
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    traj = synthetic.circle_trajectory(12)
    spec = torb.ORBSpec.create(H, W, n_features=600, n_levels=4, scale_factor=1.5,
                               max_kp=768)
    out = []
    for f in frames:
        g, _ = room.render(K, traj[f], W, H)
        kp = torb.extract(spec, torch.from_numpy(
            np.clip(g, 0, 255).astype(np.uint8).astype(np.float32)))
        out.append(kp["desc"][kp["valid"]].numpy())
    return out


@pytest.fixture(scope="module")
def descs():
    return _descriptors()


@pytest.fixture(scope="module")
def vocs(descs):
    train = np.concatenate(descs[:3])
    return jvoc.train(train, k=6, L=3, seed=1), tvoc.train(train, k=6, L=3, seed=1)


def _assert_same_voc(a, b):
    assert (a.k, a.L, a.scoring, a.weighting, a.n_words) == \
        (b.k, b.L, b.scoring, b.weighting, b.n_words)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_train_gives_equal_arrays(vocs):
    jv, tv = vocs
    _assert_same_voc(jv, tv)
    assert tv.n_words > 50
    bits = np.random.default_rng(0).integers(0, 2, (300, 256)).astype(np.uint8)
    for k in (4, 9):
        cj, aj = jvoc._kmajority(bits, k, np.random.default_rng(3))
        ct, at = tvoc._kmajority(bits, k, np.random.default_rng(3))
        np.testing.assert_array_equal(cj, ct)
        np.testing.assert_array_equal(aj, at)
    np.testing.assert_array_equal(tvoc._children_table(jv.parent, jv.k),
                                  jvoc._children_table(jv.parent, jv.k))


def test_files_cross_load(vocs, tmp_path):
    """A .bin (and a text file) written by either package loads in the
    other; the two packages write byte-identical files."""
    jv, tv = vocs
    jvoc.save_binary(tmp_path / "j.bin", jv)
    tvoc.save_binary(tmp_path / "t.bin", tv)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    _assert_same_voc(tvoc.load(tmp_path / "j.bin"), jv)
    _assert_same_voc(jvoc.load(tmp_path / "t.bin"), tv)
    jvoc.save_text(tmp_path / "j.txt", jv)
    tvoc.save_text(tmp_path / "t.txt", tv)
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()
    a, b = tvoc.load(tmp_path / "j.txt"), jvoc.load_text(tmp_path / "t.txt")
    for f in ("parent", "children", "desc", "word_id"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.weight, b.weight, atol=TOL)


def _bows(vocs, descs):
    """Per-frame (word, weight, node) from both transforms, valid mask with
    a dead tail."""
    jv, tv = vocs
    jt, tt = jvoc.make_transform_packed(jv), tvoc.make_transform_packed(tv)
    out = []
    for d in descs:
        valid = np.arange(len(d)) < len(d) - 7
        oj = jt(jnp.asarray(d), jnp.asarray(valid))
        ot = tt(torch.from_numpy(d), torch.from_numpy(valid))
        out.append(({k: np.array(v) for k, v in oj.items()},
                    {k: v.numpy() for k, v in ot.items()}))
    return out


def test_packed_transform_words_and_weights(vocs, descs):
    """The tree descent on real ORB descriptors (one frame unseen in
    training): equal words, nodes and weights."""
    for oj, ot in _bows(vocs, descs):
        for k in ("word", "node"):
            np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
        np.testing.assert_array_equal(ot["weight"], oj["weight"])
        assert (ot["word"] >= 0).sum() > 300


@pytest.mark.parametrize("m_cap", [None, 40])
def test_sparse_bow(vocs, descs, m_cap):
    """Sorted unique words with summed, L1-normalized weights; with m_cap
    under the word count, runs past the cap add into the last slot."""
    jv, _ = vocs
    for oj, _ in _bows(vocs, descs):
        m = m_cap or min(len(oj["word"]), jv.n_words)
        wj, vj = jax.jit(jvoc.sparse_bow, static_argnums=2)(
            jnp.asarray(oj["word"]), jnp.asarray(oj["weight"]), m)
        wt, vt = tvoc.sparse_bow(torch.from_numpy(oj["word"]),
                                 torch.from_numpy(oj["weight"]), m)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL)
    dense_j = jvoc.bow_vector(jnp.asarray(oj["word"]), jnp.asarray(oj["weight"]), jv.n_words)
    dense_t = tvoc.bow_vector(torch.from_numpy(oj["word"]), torch.from_numpy(oj["weight"]),
                              jv.n_words)
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j), atol=TOL)
    np.testing.assert_allclose(tvoc.score_l1(dense_t, dense_t[None]).numpy(),
                               np.asarray(jvoc.score_l1(dense_j, dense_j[None])), atol=TOL)


class _Graph(NamedTuple):
    covis: object
    kf_valid: object


def test_sparse_scores_and_detection_gates(vocs, descs):
    """A 12-row store of keyframe-like rows (overlapping subsets of the four
    frames' words): common-word counts equal, scores within 1e-6, and the
    same candidate mask from the detection gates (covisible exclusion,
    0.8 * max common words, minScore, the accumulated group score cut)."""
    jv, _ = vocs
    rng = np.random.default_rng(7)
    bows = _bows(vocs, descs)
    K, m = 12, min(jv.n_words, 768)
    words, weights = [], []
    for k in range(K):
        oj = bows[k % 4][0]
        keep = rng.random(len(oj["word"])) < (0.9 if k < 8 else 0.5)
        w, v = tvoc.sparse_bow(torch.from_numpy(np.where(keep, oj["word"], -1)),
                               torch.from_numpy(oj["weight"]), m)
        words.append(w.numpy())
        weights.append(v.numpy())
    word, weight = np.stack(words), np.stack(weights)
    word[9] = tvoc._PAD  # an empty row
    weight[9] = 0.0
    covis = np.zeros((K, K), np.int32)
    for a, b, wt in [(0, 1, 40), (1, 2, 30), (4, 5, 60), (5, 6, 20), (8, 11, 50), (3, 7, 25)]:
        covis[a, b] = covis[b, a] = wt
    kf_valid = np.ones(K, bool)
    kf_valid[10] = False
    q_word, q_weight = word[4].copy(), weight[4].copy()
    js = jdb.SparseBowStore(word=jnp.asarray(word), weight=jnp.asarray(weight))
    ts = tdb.SparseBowStore(word=torch.from_numpy(word), weight=torch.from_numpy(weight))
    cj, sj = jax.jit(jdb._sparse_common_and_scores)(js, jnp.asarray(q_word),
                                                     jnp.asarray(q_weight))
    ct, st = tdb._sparse_common_and_scores(ts, torch.from_numpy(q_word),
                                           torch.from_numpy(q_weight))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL)
    assert abs(float(st[4]) - 1.0) < 1e-5  # a row scores 1 against itself
    rows = np.array([0, 5, 9, 4], np.int32)
    np.testing.assert_allclose(
        tdb.sparse_score_rows(ts, torch.from_numpy(rows), torch.from_numpy(q_word),
                              torch.from_numpy(q_weight)).numpy(),
        np.asarray(jdb.sparse_score_rows(js, jnp.asarray(rows), jnp.asarray(q_word),
                                         jnp.asarray(q_weight))), atol=TOL)
    for min_score in (0.0, 0.05, float(np.sort(np.asarray(sj))[-4])):
        kj, scj = jdb.detect_loop_candidates_sparse(
            js, _Graph(jnp.asarray(covis), jnp.asarray(kf_valid)), jnp.asarray(q_word),
            jnp.asarray(q_weight), 4, jnp.asarray(min_score, jnp.float32))
        kt, sct = tdb.detect_loop_candidates_sparse(
            ts, _Graph(torch.from_numpy(covis), torch.from_numpy(kf_valid)),
            torch.from_numpy(q_word), torch.from_numpy(q_weight), 4,
            torch.tensor(min_score, dtype=torch.float32))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_allclose(sct.numpy(), np.asarray(scj), atol=TOL)
        assert not kt[[4, 5, 10]].any()  # the query, its covisible, an invalid slot


def test_store_rows():
    """add / erase write and clear one row, as the JAX store does."""
    w = np.arange(8, dtype=np.int32)
    v = np.full(8, 0.125, np.float32)
    ts = tdb.empty_sparse_store(5, 6)
    js = jdb.empty_sparse_store(5, 6)
    ts = tdb.add_keyframe_bow_sparse(ts, 2, torch.from_numpy(w), torch.from_numpy(v))
    js = jdb.add_keyframe_bow_sparse(js, 2, jnp.asarray(w), jnp.asarray(v))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts, js = tdb.erase_keyframe_bow_sparse(ts, 2), jdb.erase_keyframe_bow_sparse(js, 2)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bitplane_transform_matches_jax(vocs, descs):
    """The bit-plane entry point (`make_transform`) against the JAX
    version's on the same real ORB descriptors: the same words, weights
    and FeatureVector nodes."""
    jv, tv = vocs
    jt, tt = jvoc.make_transform(jv), tvoc.make_transform(tv)
    for d in descs:
        bits = np.unpackbits(d, axis=1, bitorder="little").astype(np.int8)
        valid = np.arange(len(d)) < len(d) - 7
        a = jt(jnp.asarray(bits), jnp.asarray(valid))
        b = tt(torch.from_numpy(bits), torch.from_numpy(valid))
        for key in ("word", "node"):
            np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(np.asarray(a["weight"]), b["weight"].numpy())
        assert (b["word"] >= 0).sum() > 300


def test_synthetic_full_equals_jax():
    """The ORBvoc-scale fixture at a small size: the same tree and tables
    from the same seed."""
    jv, tv = jvoc.synthetic_full(k=4, L=3, seed=2), tvoc.synthetic_full(k=4, L=3, seed=2)
    assert (tv.n_nodes, tv.n_words) == (jv.n_nodes, jv.n_words) == (85, 64)
    for f in ("parent", "children", "desc", "weight", "word_id"):
        np.testing.assert_array_equal(getattr(jv, f), getattr(tv, f), err_msg=f)
