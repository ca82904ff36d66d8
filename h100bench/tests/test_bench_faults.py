"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a chip skipped, the rest of a run driven at a tiny
size on the CPU, once for each fault the cell can have."""

import dataclasses

import numpy as np
import pytest

from h100bench.tests.conftest import run_tiny


def _alter_answer(monkeypatch):
    from desco_tpu_torch import serving

    real = serving.CountingService._guard_and_package

    def altered(self, *a, **k):
        res = real(self, *a, **k)
        nc = res.node_counts.copy()
        nc[nc.shape[0] // 2, 3] += 1.0
        return dataclasses.replace(res, node_counts=nc)

    monkeypatch.setattr(serving.CountingService, "_guard_and_package",
                        altered)


def _aggregation_off(monkeypatch):
    """Each graph's count summed without its last node's (the node whose
    canonical neighborhood is the largest)."""
    from desco_tpu_torch.data import workload

    real = workload.Workload.aggregate_node_counts

    def short(self, node_counts):
        nc = np.array(node_counts, dtype=np.float64)
        nc[np.cumsum([g.n_nodes for g in self.graphs]) - 1] = 0.0
        return real(self, nc)

    monkeypatch.setattr(workload.Workload, "aggregate_node_counts", short)


def _half_batch_served(monkeypatch):
    from desco_tpu_torch.parallel import dp

    real = dp.dp_predict_neighborhood_counts

    def half(*a, **k):
        out = np.array(real(*a, **k))
        keep = out.shape[0] // 2
        out[keep:] = out[:keep].mean(axis=0)
        return out

    monkeypatch.setattr(dp, "dp_predict_neighborhood_counts", half)


def _state_unchanged(monkeypatch):
    from desco_tpu_torch.train import loop

    monkeypatch.setattr(loop.Adam, "step", lambda self, lr, ok=None: None)


def _half_batch_trained(monkeypatch):
    from desco_tpu_torch.models import neighborhood as nm

    real = nm.train_loss

    def half(params, tgt_cfg, qry_cfg, batch, query_batch, generator=None):
        mask = batch.graph_mask
        idx = mask.nonzero()[:, 0]
        cut = mask.clone()
        cut[idx[len(idx) // 2:]] = 0.0
        return real(params, tgt_cfg, qry_cfg,
                    dataclasses.replace(batch, graph_mask=cut), query_batch,
                    generator)

    monkeypatch.setattr(nm, "train_loss", half)


def _loss_altered(monkeypatch):
    from desco_tpu_torch.models import neighborhood as nm

    real = nm.train_loss
    monkeypatch.setattr(nm, "train_loss",
                        lambda *a, **k: real(*a, **k) * 1.01)


@pytest.mark.parametrize("cell, fault", [
    ("sage-r4.serve-32g", _alter_answer),
    ("sage-r4.serve-32g", _aggregation_off),
    ("sage-r4.serve-32g", _half_batch_served),
    ("sage-r4.train-b512", _state_unchanged),
    ("sage-r4.train-b512", _half_batch_trained),
    ("sage-r4.train-b512", _loss_altered),
    ("gat.train-b512", _state_unchanged),
    ("gat.train-b512", _half_batch_trained),
])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_tiny(cell)
    assert res["correct"] is False, res["checks"]
