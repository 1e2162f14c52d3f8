"""Distributed relocalization queries over a keyframe-sharded BoW store.

Port of `orbslam_mapsave_tpu/parallel/dist_reloc.py`. The sparse BoW store
shards its rows by keyframe block, as `dist_gba.shard_map_state` shards the
map. A lost frame's query runs as:

1. the query's sparse BoW row (words, weights) is replicated;
2. each rank scores it against its own rows
   (`vocab/database._sparse_common_and_scores`), with no traffic;
3. the common-word gate (> 0.8 x the global most) and the score gate
   (> 0.75 x the global best) reduce their maxima with `pmax`;
4. each rank keeps its top min(top_k, K/n) candidates, -1 for a slot whose
   score is not finite, and one all-gather gives every rank all of them.

The JAX version's quirks are kept: no covisibility-group accumulation (a
candidate's score is its own), and a per-shard top-k, so the global set
holds up to n x top_k slots in rank order.
"""

from __future__ import annotations

import torch

from ..vocab import database
from .mesh import Mesh, local_rows


def shard_store(store: database.SparseBowStore, mesh: Mesh) -> database.SparseBowStore:
    """This rank's block of the store's rows, on its device."""
    return database.SparseBowStore(word=local_rows(store.word, mesh).to(mesh.device),
                                   weight=local_rows(store.weight, mesh).to(mesh.device))


def make_distributed_query(mesh: Mesh, top_k: int = 5):
    """query(store, kf_valid, q_word, q_weight) -> (slots (n*k,) i32, scores
    (n*k,)) with k = min(top_k, K/n), the same on every rank. `store` is
    placed by `shard_store`; kf_valid is the whole (K,) mask.

    The gates are `KeyFrameDatabase::DetectRelocalizationCandidates`'
    (`src/KeyFrameDatabase.cc:274-391`): common words > 0.8 x the most
    (:315), scores > 0.75 x the best (:368)."""

    def query(store: database.SparseBowStore, kf_valid, q_word, q_weight):
        Kl = store.word.shape[0]
        kf_valid_l = local_rows(kf_valid, mesh)
        common_l, scores_l = database._sparse_common_and_scores(store, q_word, q_weight)
        common_l = torch.where(kf_valid_l, common_l, torch.zeros_like(common_l))
        max_common = mesh.pmax(torch.max(common_l))
        min_common = (0.8 * max_common).to(torch.int32)
        ok_l = kf_valid_l & (common_l > min_common)
        neg_inf = torch.full_like(scores_l, -torch.inf)
        best_acc = mesh.pmax(torch.max(torch.where(ok_l, scores_l, neg_inf)))
        keep_l = ok_l & (scores_l > 0.75 * best_acc)
        top_s, top_i = database._top_k(torch.where(keep_l, scores_l, neg_inf), min(top_k, Kl))
        slots = torch.where(torch.isfinite(top_s), top_i.to(torch.int32) + mesh.axis_index() * Kl,
                            torch.full_like(top_i, -1, dtype=torch.int32))
        return mesh.all_gather(slots), mesh.all_gather(top_s)

    return query
