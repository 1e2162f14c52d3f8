"""Keyframe database: BoW retrieval for loop detection and relocalization.

Port of `orbslam_mapsave_tpu/vocab/database.py` (`KeyFrameDatabase`,
`src/KeyFrameDatabase.cc`). Two stores: the dense one keeps each
keyframe's BoW vector as a row of a (K, W) matrix (common words and L1
scores against every row are one product and one reduction); the sparse
one keeps each keyframe's sorted sparse row (K, M) and intersects the
query against every row at once by a sorted merge. The reference's gates
run as masked reductions: minCommonWords = 0.8 * maxCommonWords
(`:195,315`), the minScore floor (loop detection only), and the
covisibility-group score accumulated over each candidate's top-10
covisibles with the 0.75 * bestAccScore cut (`:227-258,342-380`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..slammap import mapstate as ms
from .vocabulary import _PAD


def empty_bow_store(max_keyframes: int, n_words: int, device="cpu") -> torch.Tensor:
    return torch.zeros((max_keyframes, n_words), dtype=torch.float32, device=device)


def add_keyframe_bow(store: torch.Tensor, kf_slot: int, bow: torch.Tensor) -> torch.Tensor:
    """`KeyFrameDatabase::add` (`:115-121`)."""
    store = store.clone()
    store[kf_slot] = bow
    return store


def erase_keyframe_bow(store: torch.Tensor, kf_slot: int) -> torch.Tensor:
    """`KeyFrameDatabase::erase` (`:123-142`)."""
    store = store.clone()
    store[kf_slot] = 0.0
    return store


def _common_words_and_scores(store: torch.Tensor, query: torch.Tensor):
    """(common (K,) i32, L1 scores (K,)): 1 - 0.5 * |row - query|_1."""
    common = (store > 0).to(torch.float32) @ (query > 0).to(torch.float32)
    scores = 1.0 - 0.5 * torch.sum(torch.abs(store - query[None, :]), dim=-1)
    return common.to(torch.int32), scores


def _group_gate(state: ms.MapState, ok: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The accumulated covisibility-group score over each candidate's top-10
    covisibles and the 0.75 * bestAccScore cut (`:227-258,342-380`)."""
    top_w, top_kf = _top_k(state.covis, 10)
    neigh_ok = (top_w > 0) & ok[top_kf]
    neigh_scores = torch.where(neigh_ok, scores[top_kf], torch.zeros_like(scores[top_kf]))
    acc = torch.where(ok, scores, torch.zeros_like(scores)) + torch.sum(neigh_scores, -1)
    best_acc = torch.amax(torch.where(ok, acc, torch.full_like(acc, -torch.inf)))
    return ok & (acc > 0.75 * best_acc)


def _loop_gate(state: ms.MapState, common: torch.Tensor, scores: torch.Tensor,
               query_kf: int, min_score) -> tuple[torch.Tensor, torch.Tensor]:
    K = common.shape[0]
    connected = state.covis[query_kf] > 0
    eligible = state.kf_valid & ~connected & (torch.arange(K, device=connected.device)
                                              != query_kf)
    common = torch.where(eligible, common, 0)
    min_common = (0.8 * torch.amax(common).to(torch.float32)).to(torch.int32)  # :195
    ok = eligible & (common > min_common) & (scores >= min_score)
    return _group_gate(state, ok, scores), scores


def _reloc_gate(state: ms.MapState, common: torch.Tensor, scores: torch.Tensor):
    common = torch.where(state.kf_valid, common, 0)
    min_common = (0.8 * torch.amax(common).to(torch.float32)).to(torch.int32)  # :315
    ok = state.kf_valid & (common > min_common)
    return _group_gate(state, ok, scores), scores


def detect_loop_candidates(store: torch.Tensor, state: ms.MapState, query_bow: torch.Tensor,
                           query_kf: int, min_score):
    """`DetectLoopCandidates` (`src/KeyFrameDatabase.cc:151-272`) over the
    dense store: excludes the query's covisible neighbours; gates common
    words > 0.8*max, score >= minScore, then the group score. Returns
    (candidate_mask (K,), scores (K,))."""
    common, scores = _common_words_and_scores(store, query_bow)
    return _loop_gate(state, common, scores, query_kf, min_score)


def detect_relocalization_candidates(store: torch.Tensor, state: ms.MapState,
                                     query_bow: torch.Tensor):
    """`DetectRelocalizationCandidates` (`src/KeyFrameDatabase.cc:274-391`)
    over the dense store: the loop gates minus the covisibility exclusion
    and the minScore floor."""
    common, scores = _common_words_and_scores(store, query_bow)
    return _reloc_gate(state, common, scores)


class SparseBowStore(NamedTuple):
    word: torch.Tensor  # (K,M) i32 sorted ascending, INT32_MAX pad
    weight: torch.Tensor  # (K,M) f32, 0 on pads


def empty_sparse_store(max_keyframes: int, m_words: int, device="cpu") -> SparseBowStore:
    return SparseBowStore(
        word=torch.full((max_keyframes, m_words), _PAD, dtype=torch.int32, device=device),
        weight=torch.zeros((max_keyframes, m_words), dtype=torch.float32, device=device))


def add_keyframe_bow_sparse(store: SparseBowStore, kf_slot: int, words: torch.Tensor,
                            weights: torch.Tensor) -> SparseBowStore:
    """`KeyFrameDatabase::add` — rows come from `vocabulary.sparse_bow`."""
    m = store.word.shape[1]
    word, weight = store.word.clone(), store.weight.clone()
    word[kf_slot] = words[:m]
    weight[kf_slot] = weights[:m]
    return SparseBowStore(word=word, weight=weight)


def erase_keyframe_bow_sparse(store: SparseBowStore, kf_slot: int) -> SparseBowStore:
    """`KeyFrameDatabase::erase`."""
    word, weight = store.word.clone(), store.weight.clone()
    word[kf_slot] = _PAD
    weight[kf_slot] = 0.0
    return SparseBowStore(word=word, weight=weight)


def _sparse_common_and_scores(store: SparseBowStore, q_word: torch.Tensor,
                              q_weight: torch.Tensor):
    """(common (K,), scores (K,)) against all rows: the query words joined
    onto every row and sorted, so a shared word is an equal adjacent pair
    (words are unique within each side); score = sum over shared words of
    min(v1, v2), which is 1 - 0.5*|v1 - v2|_1 for L1-normalized vectors
    (`L1Scoring::score`, ScoringObject.cpp:23-70)."""
    K = store.word.shape[0]
    Mq = q_word.shape[0]
    q_w = torch.where(q_weight > 0, q_word, _PAD)  # dead query entries never match
    words = torch.cat([q_w[None, :].expand(K, Mq), store.word], dim=1)
    vals = torch.cat([q_weight[None, :].expand(K, Mq), store.weight], dim=1)
    sw, order = torch.sort(words, dim=1, stable=True)
    sv = torch.gather(vals, 1, order)
    match = (sw[:, 1:] == sw[:, :-1]) & (sw[:, 1:] != _PAD)
    contrib = torch.minimum(sv[:, 1:], sv[:, :-1])
    common = torch.sum(match.to(torch.int32), -1)
    scores = torch.sum(torch.where(match, contrib, torch.zeros_like(contrib)), -1)
    return common, scores


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_loop_candidates_sparse(store: SparseBowStore, state: ms.MapState,
                                  q_word: torch.Tensor, q_weight: torch.Tensor,
                                  query_kf: int, min_score: torch.Tensor):
    """`DetectLoopCandidates` (`src/KeyFrameDatabase.cc:151-272`) over the
    sparse store, the gates of `detect_loop_candidates`. Returns
    (candidate_mask (K,), scores (K,))."""
    common, scores = _sparse_common_and_scores(store, q_word, q_weight)
    return _loop_gate(state, common, scores, query_kf, min_score)


def detect_relocalization_candidates_sparse(store: SparseBowStore, state: ms.MapState,
                                            q_word: torch.Tensor, q_weight: torch.Tensor):
    """`DetectRelocalizationCandidates` (`src/KeyFrameDatabase.cc:274-391`)
    over the sparse store (`database.py:177-194`), the gates of
    `detect_relocalization_candidates`."""
    common, scores = _sparse_common_and_scores(store, q_word, q_weight)
    return _reloc_gate(state, common, scores)


def sparse_score_rows(store: SparseBowStore, rows: torch.Tensor, q_word: torch.Tensor,
                      q_weight: torch.Tensor) -> torch.Tensor:
    """L1 scores of the query against selected rows (the covisible
    minScore floor, `LoopClosing.cc:125-139`)."""
    r = rows.long()
    _, scores = _sparse_common_and_scores(
        SparseBowStore(word=store.word[r], weight=store.weight[r]), q_word, q_weight)
    return scores
