"""desco_tpu_torch count head, neighborhood predictor and gossip model
against desco_tpu, on the same inputs and weights (desco_tpu's init,
carried over with ``params_from_jax``). Float32 on both sides: rtol 1e-4
/ atol 1e-5 for activations; de-logged counts (2^pred - 1) amplify
pred's rounding by ln 2 * count, so they compare at rtol 1e-4 of the
count."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import random_graph
from desco_tpu.models import gossip as jgossip
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.pipeline import model_configs as j_model_configs
from desco_tpu.pipeline import PipelineConfig as JConfig
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.build import gossip_sample
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.pipeline import PipelineConfig, build_query_batch
from desco_tpu_torch.pipeline import model_configs as t_model_configs
from desco_tpu_torch.train.checkpoint import jax_key, params_from_jax

from test_torch_shmp import (  # noqa: F401 (autouse fixture)
    jax_batch, one_torch_thread, target_batch)

CFG = dict(neigh_layer_num=2, neigh_hidden_dim=16, agg_mode="aggregate_first")


@pytest.fixture(scope="module")
def neigh_models():
    jt, jq = j_model_configs(JConfig(**CFG))
    tt, tq = t_model_configs(PipelineConfig(**CFG), "cpu")
    jparams = jneigh.init_neighborhood_model(jax.random.PRNGKey(3), jt, jq)
    return (jt, jq, jparams), (tt, tq, params_from_jax(_flatten(jparams)))


def test_count_head_matches(neigh_models, rng):
    (_, _, jp), (_, _, tp) = neigh_models
    emb_t = rng.standard_normal((7, 16)).astype(np.float32)
    emb_q = rng.standard_normal((29, 16)).astype(np.float32)
    ref = np.asarray(jneigh.count_head(jp, jnp.asarray(emb_t),
                                       jnp.asarray(emb_q)))
    with torch.inference_mode():
        out = tneigh.count_head(tp, torch.from_numpy(emb_t),
                                torch.from_numpy(emb_q)).numpy()
    assert out.shape == (7, 29)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_predict_counts_matches(neigh_models):
    (jt, jq, jp), (tt, tq, tp) = neigh_models
    batch = target_batch(seed=7)
    qb = build_query_batch(PipelineConfig(**CFG))
    emb_q_ref = jneigh.embed_queries(jp, jq, jax_batch(qb))
    ref = np.asarray(jneigh.predict_counts_from_embs(jp, jt, jax_batch(batch),
                                                     emb_q_ref))
    ref_full = np.asarray(jneigh.predict_counts(jp, jt, jq, jax_batch(batch),
                                                jax_batch(qb)))
    with torch.inference_mode():
        emb_q = tneigh.embed_queries(tp, tq, qb.to("cpu"))
        out = tneigh.predict_counts_from_embs(tp, tt, batch.to("cpu"),
                                              emb_q).numpy()
        full = tneigh.predict_counts(tp, tt, tq, batch.to("cpu"),
                                     qb.to("cpu")).numpy()
    np.testing.assert_allclose(emb_q.numpy(), np.asarray(emb_q_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(full, ref_full, rtol=1e-4, atol=1e-5)


def gossip_batch(seed=0, n_q=29):
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(4):
        g = random_graph(rng, 12, 0.3)
        g = Graph(g.n_nodes, g.edges)
        x = rng.integers(0, 20, (g.n_nodes, n_q)).astype(np.float32)
        samples.append(gossip_sample(g, x, np.zeros_like(x)))
    (b,) = pack_samples(samples, *auto_capacities(samples, g_cap=8),
                        n_queries=n_q, need_bwd_perm=False)
    return b


@pytest.mark.parametrize("hidden,emb", [(8, 16), (16, 16)])
def test_gossip_matches(hidden, emb, rng):
    jp = jgossip.init_gossip_model(jax.random.PRNGKey(hidden), input_dim=1,
                                   hidden_dim=hidden, emb_channels=emb,
                                   layer_num=2)
    tp = params_from_jax(_flatten(jp))
    batch = gossip_batch(seed=hidden)
    q_embs = rng.standard_normal((29, emb)).astype(np.float32)
    jb = jax_batch(batch)
    ref = np.asarray(jgossip.gossip_predict(jp, jb, jnp.asarray(q_embs)))
    ref1 = np.asarray(jgossip.apply_gossip_single(
        jp, jb, jb.x[:, 3], jnp.asarray(q_embs[3])))
    ref_gates = np.asarray(jgossip.gate_values(jp, jnp.asarray(q_embs)))
    tb, tq = batch.to("cpu"), torch.from_numpy(q_embs)
    with torch.inference_mode():
        out = tgossip.gossip_predict(tp, tb, tq).numpy()
        one = tgossip.apply_gossip_single(tp, tb, tb.x[:, 3], tq[3]).numpy()
        gates = np.array([[float(tgossip._gate(c, q)) for q in tq]
                          for c in tp["convs"]])
    np.testing.assert_allclose(gates, ref_gates, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(one, ref1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_fresh_init_layout_matches_desco_tpu():
    """init_neighborhood_model / init_gossip_model give desco_tpu's key
    paths and shapes, so checkpoints map one to one."""
    jt, jq = j_model_configs(JConfig(**CFG))
    tt, tq = t_model_configs(PipelineConfig(**CFG), "cpu")
    gen = torch.Generator().manual_seed(0)
    pairs = [
        (jneigh.init_neighborhood_model(jax.random.PRNGKey(0), jt, jq),
         tneigh.init_neighborhood_model(tt, tq, gen)),
        (jgossip.init_gossip_model(jax.random.PRNGKey(1), hidden_dim=8,
                                   emb_channels=16),
         tgossip.init_gossip_model(hidden_dim=8, emb_channels=16,
                                   generator=gen)),
    ]
    for jp, tp in pairs:
        jshapes = {k: v.shape for k, v in _flatten(jp).items()}
        tshapes = {jax_key(k): tuple(v.shape)
                   for k, v in tp.state_dict().items()}
        assert jshapes == tshapes
