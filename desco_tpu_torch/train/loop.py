"""Batched prediction — the predict half of ``desco_tpu/train/loop.py``
(:355-494). Training (Adam, the plateau schedule, checkpointed epochs)
comes with the training slice (ROADMAP.md, Queue 1 M7).

A request's packed batches are consecutive views of one host block
(``pack_samples``), so they move to the device in one copy; every batch
is dispatched before the one read-back at the end.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..batch.packed import PackedGraphs, stack_batches
from ..models import gossip as gossip_mod
from ..models import neighborhood as neigh_mod


def _valid_rows(batches: List[PackedGraphs], preds: torch.Tensor,
                mask_field: str) -> np.ndarray:
    all_preds = preds.cpu().numpy()
    out = [p[np.asarray(getattr(b, mask_field)) > 0]
           for b, p in zip(batches, all_preds)]
    return np.concatenate(out, axis=0)


def predict_neighborhood_counts(params, tgt_cfg, query_embs: torch.Tensor,
                                batches: List[PackedGraphs],
                                device) -> np.ndarray:
    """(#valid graphs over all batches, Q) de-logged stage-1 counts.
    ``query_embs`` ([Q, H] on ``device``, ``embed_queries``) come from the
    query tower, which a service runs once: the query set is static."""
    with torch.inference_mode():
        stacked = stack_batches(batches).to(device)
        preds = torch.stack([
            neigh_mod.predict_counts_from_embs(params, tgt_cfg,
                                               stacked[bi], query_embs)
            for bi in range(len(batches))])  # [B, g_cap, Q]
        return _valid_rows(batches, preds, "graph_mask")


def predict_gossip_counts(params, query_embs: torch.Tensor,
                          batches: List[PackedGraphs],
                          device) -> np.ndarray:
    """(#total_nodes, Q) refined per-node counts in node order."""
    with torch.inference_mode():
        stacked = stack_batches(batches).to(device)
        preds = torch.stack([
            gossip_mod.gossip_predict(params, stacked[bi], query_embs)
            for bi in range(len(batches))])  # [B, n_cap, Q]
        return _valid_rows(batches, preds, "node_mask")
