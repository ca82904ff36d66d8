"""desco_tpu_torch SHMP towers against desco_tpu's ``apply_shmp``.

Same packed batch, same weights (desco_tpu's init, carried over with
``params_from_jax``), desco_tpu on its XLA float32 path
(``agg_mode='aggregate_first'``). Tolerance rtol 1e-4 / atol 1e-5: float32
on both sides, only the summation order differs."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import random_graph
from desco_tpu.batch.packed import PackedGraphs as JPacked
from desco_tpu.models import shmp_gnn as jshmp
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.models import shmp_gnn as tshmp
from desco_tpu_torch.pipeline import PipelineConfig, build_query_batch
from desco_tpu_torch.train.checkpoint import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch CPU ops on one intra-op thread. The Tier-1 run puts six test
    workers on the cores; OpenMP threads that spin waiting for busy
    cores then slow the port's small CPU ops a hundredfold. The port's
    other CPU test files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def target_batch(seed=0, n_graphs=5, n_nodes=14, p=0.3):
    rng = np.random.default_rng(seed)
    graphs = [random_graph(rng, n_nodes, p) for _ in range(n_graphs)]
    graphs = [Graph(g.n_nodes, g.edges) for g in graphs]
    samples, _ = Workload(graphs).neighborhood_samples(depth=2)
    for s in samples:  # random inputs exercise the pre-linear fully
        s.x = rng.standard_normal((s.n_nodes, 1)).astype(np.float32)
    batches = pack_samples(samples, *auto_capacities(samples, g_cap=64),
                           need_bwd_perm=False)
    assert len(batches) == 1
    return batches[0]


def jax_batch(b):
    return jax.tree_util.tree_map(jnp.asarray, JPacked(**dict(b.fields())))


def tower_cfgs(kind, layers, hidden, agg_mode="aggregate_first"):
    kw = dict(input_dim=1, hidden_dim=hidden, output_dim=hidden,
              layer_num=layers)
    if kind == "target":
        return (jshmp.neighborhood_target_config(**kw),
                tshmp.neighborhood_target_config(agg_mode=agg_mode, **kw))
    return jshmp.query_config(**kw), tshmp.query_config(**kw)


@pytest.mark.parametrize("kind,layers,hidden,agg_mode", [
    ("target", 2, 16, "aggregate_first"),
    ("target", 3, 32, "aggregate_first"),
    ("target", 3, 32, "kernel"),
    ("query", 3, 32, "aggregate_first"),
])
def test_tower_matches_apply_shmp(kind, layers, hidden, agg_mode):
    jcfg, tcfg = tower_cfgs(kind, layers, hidden, agg_mode)
    if kind == "target":
        batch = target_batch(seed=layers)
    else:
        batch = build_query_batch(PipelineConfig())
    jparams = jshmp.init_shmp(jax.random.PRNGKey(layers), jcfg)
    tparams = params_from_jax(_flatten(jparams))
    jb, tb = jax_batch(batch), batch.to("cpu")
    ref_core = np.asarray(jshmp.apply_shmp_core(jparams, jcfg, jb))
    ref = np.asarray(jshmp.apply_shmp(jparams, jcfg, jb))
    with torch.inference_mode():
        core = tshmp.apply_shmp_core(tparams, tcfg, tb).numpy()
        out = tshmp.apply_shmp(tparams, tcfg, tb).numpy()
    np.testing.assert_allclose(core, ref_core, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_fresh_init_has_desco_tpu_layout():
    """Port-initialized towers carry desco_tpu's keys and shapes, and the
    torch-Linear U(+-1/sqrt(fan_in)) range."""
    from desco_tpu_torch.train.checkpoint import jax_keys

    jcfg, tcfg = tower_cfgs("target", 3, 16)
    jflat = _flatten(jshmp.init_shmp(jax.random.PRNGKey(0), jcfg))
    tparams = tshmp.init_shmp(tcfg, torch.Generator().manual_seed(0))
    keys = jax_keys(tparams)
    tflat = {keys[k]: v for k, v in tparams.state_dict().items()}
    assert {k: v.shape for k, v in jflat.items()} == {
        k: tuple(v.shape) for k, v in tflat.items()}
    for key, v in tflat.items():
        fan_in = jflat[key.rsplit("/", 1)[0] + "/0"].shape[-2]
        assert float(v.abs().max()) <= 1.0 / np.sqrt(fan_in) + 1e-7, key


def test_unported_conv_types_raise():
    """Every conv type of desco_tpu is ported, and order-4 typing; a conv
    type desco_tpu does not have raises, as desco_tpu's init_shmp does."""
    cfg = tower_cfgs("target", 2, 8)[1]
    with pytest.raises(NotImplementedError, match="SAGE, GIN, GCN, GAT"):
        dataclasses.replace(cfg, conv_type="GOSSIP")
    for conv in ("GIN", "GCN", "GAT", "PNA"):
        assert dataclasses.replace(cfg, conv_type=conv).conv_type == conv
    with pytest.raises(ValueError, match="agg_mode"):
        tshmp.SHMPConfig(agg_mode="cumsum")
    assert tshmp.neighborhood_target_config(order=4).n_edge_types == 33
