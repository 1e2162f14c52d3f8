"""Keyframe database: BoW retrieval for loop detection.

Port of `orbslam_mapsave_tpu/vocab/database.py`, the sparse store
(`KeyFrameDatabase`, `src/KeyFrameDatabase.cc`): each keyframe keeps its
sorted sparse BoW row (K, M); retrieval intersects the query row against
every row at once by a sorted merge, and the reference's gates run as
masked reductions — minCommonWords = 0.8 * maxCommonWords (`:195`), the
minScore floor, and the covisibility-group score accumulated over each
candidate's top-10 covisibles with the 0.75 * bestAccScore cut
(`:227-258`). The dense (K, W) store and the relocalization detectors wait
for the relocalization slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..slammap import mapstate as ms
from .vocabulary import _PAD


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
    """`DetectLoopCandidates` (`src/KeyFrameDatabase.cc:151-272`): excludes
    the query's covisible neighbours; gates common words > 0.8*max, score >=
    minScore, then the accumulated covisibility-group score with the
    0.75*bestAccScore cut. Returns (candidate_mask (K,), scores (K,))."""
    K = store.word.shape[0]
    connected = state.covis[query_kf] > 0
    eligible = state.kf_valid & ~connected & (torch.arange(K, device=connected.device)
                                              != query_kf)
    common, scores = _sparse_common_and_scores(store, q_word, q_weight)
    common = torch.where(eligible, common, 0)
    min_common = (0.8 * torch.amax(common).to(torch.float32)).to(torch.int32)  # :195
    ok = eligible & (common > min_common) & (scores >= min_score)
    top_w, top_kf = _top_k(state.covis, 10)
    neigh_ok = (top_w > 0) & ok[top_kf]
    neigh_scores = torch.where(neigh_ok, scores[top_kf], torch.zeros_like(scores[top_kf]))
    acc = torch.where(ok, scores, torch.zeros_like(scores)) + torch.sum(neigh_scores, -1)
    best_acc = torch.amax(torch.where(ok, acc, torch.full_like(acc, -torch.inf)))
    keep = ok & (acc > 0.75 * best_acc)  # :251
    return keep, scores


def sparse_score_rows(store: SparseBowStore, rows: torch.Tensor, q_word: torch.Tensor,
                      q_weight: torch.Tensor) -> torch.Tensor:
    """L1 scores of the query against selected rows (the covisible
    minScore floor, `LoopClosing.cc:125-139`)."""
    r = rows.long()
    _, scores = _sparse_common_and_scores(
        SparseBowStore(word=store.word[r], weight=store.weight[r]), q_word, q_weight)
    return scores
