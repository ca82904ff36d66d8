"""desco_tpu_torch's GIN, GCN, GAT and PNA convolutions against desco_tpu.

Same packed batch, same weights (desco_tpu's init, carried over with
``params_from_jax``), dropout 0. desco_tpu runs ``apply_shmp`` on its XLA
float32 path (``agg_mode='aggregate_first'``); the port runs both of its
modes on the CPU (``aggregate_first`` and ``kernel``, the kernels' plain
versions; GAT and PNA aggregate through their own providers in either).
Tolerances: values rtol 2e-4 / atol 1e-4 (float32 on both sides, only
the summation order differs, through exp / sqrt / log); gradients rtol
1e-4 with atol 1e-6 of each tensor's scale, as tests/test_torch_grad.py;
the bf16 tower within 0.05 of desco_tpu's bf16 tower in log2(count + 1)
space, tests/test_torch_bf16.py's bound (the port sums bf16 rows in f32,
desco_tpu's CPU path in bf16)."""

import copy
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from desco_tpu.models import neighborhood as jneigh
from desco_tpu.models import shmp_gnn as jshmp
from desco_tpu.train import checkpoint as jckpt
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.models import shmp_gnn as tshmp
from desco_tpu_torch.pipeline import PipelineConfig, build_query_batch
from desco_tpu_torch.train import checkpoint as tckpt
from desco_tpu_torch.train.checkpoint import (
    flatten_params,
    jax_keys,
    params_from_jax,
)

from test_torch_grad import assert_grads_match
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401
from test_torch_shmp import target_batch

CONVS = ["GIN", "GCN", "GAT", "PNA"]
BF = torch.bfloat16


def tower(conv, layers=3, hidden=16, agg_mode="aggregate_first", seed=0,
          **kw):
    """(desco_tpu config, params), (port config, params) of a target
    tower, the weights drawn by desco_tpu."""
    args = dict(input_dim=1, hidden_dim=hidden, output_dim=hidden,
                layer_num=layers, conv_type=conv, **kw)
    jcfg = jshmp.neighborhood_target_config(**args)
    tcfg = tshmp.neighborhood_target_config(agg_mode=agg_mode, **args)
    jparams = jshmp.init_shmp(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jparams), (tcfg, params_from_jax(_flatten(jparams)))


def tied_batch():
    """Every node's input is 1: at layer 0 all count nodes (and all
    canonical nodes) carry one pre row, so the segment min / max of PNA
    and GAT's logits tie everywhere."""
    b = target_batch(seed=2)
    b.x = np.ones_like(b.x) * b.node_mask[:, None]
    return b


def empty_segments(batch, t):
    """The valid nodes' (dst, type) segments that no edge reaches."""
    live = batch.edge_type < t
    hit = np.zeros((batch.n_cap, t), bool)
    hit[batch.edge_dst[live], batch.edge_type[live]] = True
    return int((~hit[batch.node_mask > 0]).sum())


def core_and_out(jcfg, jparams, tcfg, tparams, batch):
    jb, tb = jax_batch(batch), batch.to("cpu")
    ref_core = np.asarray(jshmp.apply_shmp_core(jparams, jcfg, jb))
    ref = np.asarray(jshmp.apply_shmp(jparams, jcfg, jb))
    with torch.inference_mode():
        core = tshmp.apply_shmp_core(tparams, tcfg, tb).numpy()
        out = tshmp.apply_shmp(tparams, tcfg, tb).numpy()
    return (core, ref_core), (out, ref)


@pytest.mark.parametrize("agg_mode", ["aggregate_first", "kernel"])
@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("inputs", ["random", "tied"])
def test_conv_tower_matches_apply_shmp(conv, agg_mode, inputs):
    (jcfg, jparams), (tcfg, tparams) = tower(conv, agg_mode=agg_mode)
    batch = target_batch(seed=1) if inputs == "random" else tied_batch()
    assert empty_segments(batch, tcfg.n_edge_types) > 0
    for got, want in core_and_out(jcfg, jparams, tcfg, tparams, batch):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("inputs", ["random", "tied"])
def test_conv_tower_gradients_match_jax_grad(conv, inputs):
    """Gradients of sum(apply_shmp * cot) in every parameter, the
    port's kernel mode (K3's plain version behind GIN / GCN, K1 and K4's
    behind GAT / PNA, scatter_reduce's tie shares) against jax.grad.

    PNA differs from desco_tpu in how it computes its variance: desco_tpu
    takes E[z^2] - E[z]^2 in f32, which keeps only eps * mean^2 / var of
    its relative accuracy, and the port takes the sum of squared
    deviations (models/shmp_gnn.pna_aggregator). Where a segment's spread
    is far below its mean, desco_tpu's std and the gradient of its sqrt,
    1 / (2 std), are rounding noise; from the second layer on such
    segments occur (15 at two layers on this batch, relative variance 2e-9
    and up). So PNA is compared at one layer; with random inputs the two
    variances still differ there by up to 5e-5 of a gradient's scale, so
    that case is held at chip_smoke.py phase 5's bound, 1e-4 of each
    tensor's scale; the tied case takes its pre and conv weights rounded
    to multiples of 1/8, so z is exact in f32, every fully tied segment's
    variance is exactly 0 in both packages, and the element-wise bound
    holds."""
    (jcfg, jparams), _ = tower(
        conv, layers=1 if conv == "PNA" else 2, agg_mode="kernel", seed=4)
    if conv == "PNA" and inputs == "tied":
        for key in ("pre", "conv"):
            jparams[key] = jax.tree_util.tree_map(
                lambda a: jnp.round(a * 8) / 8, jparams[key])
    tcfg = tshmp.neighborhood_target_config(
        agg_mode="kernel", **{f: getattr(jcfg, f) for f in (
            "input_dim", "hidden_dim", "output_dim", "layer_num",
            "conv_type")})
    tparams = params_from_jax(_flatten(jparams))
    batch = target_batch(seed=3) if inputs == "random" else tied_batch()
    cot = np.random.default_rng(5).standard_normal(
        (batch.g_cap, jcfg.output_dim)).astype(np.float32)
    jb = jax_batch(batch)
    jgrads = jax.grad(lambda p: (jshmp.apply_shmp(p, jcfg, jb)
                                 * jnp.asarray(cot)).sum())(jparams)
    tparams.requires_grad_(True)
    (tshmp.apply_shmp(tparams, tcfg, batch.to("cpu", training=True))
     * torch.from_numpy(cot)).sum().backward()
    if conv == "PNA" and inputs == "random":
        keys = jax_keys(tparams)
        got = {keys[n]: p.grad.numpy()
               for n, p in tparams.named_parameters()}
        for key, want in _flatten(jgrads).items():
            scale = float(np.abs(want).max())
            assert np.abs(got[key] - want).max() <= 1e-4 * scale, key
    else:
        assert_grads_match(tparams, jgrads, min_nonzero=5)


def test_pna_gradients_do_not_depend_on_summation_order():
    """The same PNA tower (8 layers) on one batch and on the batch with
    every (dst, type) run's edges reversed: only the order of each sum
    changes. With the two-pass variance every gradient agrees to 1e-5 of
    its tensor's scale (2.9e-7 measured on a batch of this kind); with
    desco_tpu's E[z^2] - E[z]^2 they differed by 1.2e-3 there."""
    batch = target_batch(seed=3)
    keys = batch.edge_dst.astype(np.int64) * 6 + batch.edge_type
    rev = dataclasses.replace(batch)
    order = np.lexsort((-np.arange(len(keys)), keys))
    for f in ("edge_src", "edge_dst", "edge_type"):
        setattr(rev, f, getattr(batch, f)[order].copy())
    rev.edge_bwd_perm = None
    cfg = tshmp.neighborhood_target_config(hidden_dim=16, output_dim=16,
                                           layer_num=8, conv_type="PNA")
    params = tshmp.init_shmp(cfg, torch.Generator().manual_seed(1))
    cot = torch.randn(batch.g_cap, 16,
                      generator=torch.Generator().manual_seed(2))
    grads = []
    for b in (batch, rev):
        p = copy.deepcopy(params).requires_grad_(True)
        (tshmp.apply_shmp(p, cfg, b.to("cpu")) * cot).sum().backward()
        grads.append({n: q.grad for n, q in p.named_parameters()})
    for n, g in grads[0].items():
        assert float((grads[1][n] - g).abs().max()) <= 1e-5 * float(
            g.abs().max()), n


@pytest.mark.parametrize("conv", CONVS)
def test_conv_bf16_tower_tracks_desco_tpu(conv):
    """The bf16 target tower through the count head, in log2(count + 1)
    space, against desco_tpu's bf16 tower and the port's f32 one."""
    kw = dict(hidden_dim=16, output_dim=16, conv_type=conv)
    jt = jshmp.neighborhood_target_config(layer_num=3, **kw)
    jq = jshmp.query_config(layer_num=2, **kw)
    tt = tshmp.neighborhood_target_config(layer_num=3, **kw)
    tq = tshmp.query_config(layer_num=2, **kw)
    jp = jneigh.init_neighborhood_model(jax.random.PRNGKey(0), jt, jq)
    tp = params_from_jax(_flatten(jp))
    batch = target_batch(seed=4)
    qb = build_query_batch(PipelineConfig(query_sizes=(3,)))
    ref_bf = np.asarray(jneigh.forward_counts(
        jp, dataclasses.replace(jt, dtype=jnp.bfloat16), jq,
        jax_batch(batch), jax_batch(qb)))
    with torch.inference_mode():
        b, q = batch.to("cpu"), qb.to("cpu")
        p32 = tneigh.forward_counts(tp, tt, tq, b, q)
        pbf = tneigh.forward_counts(tp, dataclasses.replace(tt, dtype=BF),
                                    tq, b, q)
    assert pbf.dtype == torch.float32
    m = batch.graph_mask > 0
    np.testing.assert_allclose(pbf.numpy()[m], ref_bf[m], atol=0.05)
    np.testing.assert_allclose(pbf.numpy()[m], p32.numpy()[m], atol=0.05)


@pytest.mark.parametrize("conv", CONVS)
def test_fresh_init_has_desco_tpu_layout(conv):
    """Port-initialized towers carry desco_tpu's keys and shapes for
    every conv type (upd1 / upd2, att as a pair, pna_mix as a bare
    array)."""
    (jcfg, jparams), (tcfg, _) = tower(conv)
    tparams = tshmp.init_shmp(tcfg, torch.Generator().manual_seed(0))
    want = {k: v.shape for k, v in _flatten(jparams).items()}
    assert {k: tuple(v.shape) for k, v in
            flatten_params(tparams).items()} == want


@pytest.mark.parametrize("conv", ["GAT", "PNA", "GIN"])
def test_params_round_trip_both_ways(conv, tmp_path):
    """params_from_jax -> flatten_params gives desco_tpu's arrays back
    under desco_tpu's keys; a checkpoint the port saves loads in
    desco_tpu's ``load_checkpoint``, and one desco_tpu saves loads in the
    port's, array for array."""
    (jcfg, jparams), (tcfg, tparams) = tower(conv)
    jflat = _flatten(jparams)
    if conv == "GAT":
        assert isinstance(tparams["att"], torch.nn.ParameterList)
        np.testing.assert_array_equal(tparams["att"][0].detach().numpy(),
                                      np.asarray(jparams["att"][0]))
    if conv == "PNA":
        assert isinstance(tparams["pna_mix"], torch.nn.Parameter)
        assert "pna_mix" in dict(tparams.named_parameters())
    back = flatten_params(tparams)
    assert set(back) == set(jflat)
    for k in jflat:
        np.testing.assert_array_equal(back[k], jflat[k])
    # port -> desco_tpu
    path = str(tmp_path / "port")
    tckpt.save_checkpoint(path, tparams, config={"conv_type": conv})
    restored, _, meta = jckpt.load_checkpoint(path, jparams)
    assert meta["config"]["conv_type"] == conv
    for k, v in _flatten(restored).items():
        np.testing.assert_array_equal(v, jflat[k])
    # desco_tpu -> port
    path = str(tmp_path / "jax")
    jckpt.save_checkpoint(path, jparams, config={"conv_type": conv})
    loaded, meta = tckpt.load_checkpoint(path)
    for k, v in flatten_params(loaded).items():
        np.testing.assert_array_equal(v, jflat[k])
    with open(path + ".json") as f:
        assert json.load(f)["config"] == meta["config"]
    assert os.path.exists(path + ".params.npz")
