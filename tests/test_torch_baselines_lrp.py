"""desco_tpu_torch's LRP baseline, query mining and both baseline
drivers against desco_tpu's (the DIAMNet parts are in
tests/test_torch_baselines.py, whose helpers and tolerances these tests
share): LRP's host permutation arrays equal, its forward rtol 1e-4 and
every weight's gradient within 1e-4 of the tensor's scale; mined queries
equal for a seed; ``python -m desco_tpu_torch.baseline`` against
desco_tpu's root ``baseline.py``, normed MSE and MAE after one training
step rtol 1e-3. Mirrors tests/test_lrp.py."""

import dataclasses
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import baseline as jbaseline
from desco_tpu.models import baseline_diamnet as jbd
from desco_tpu.models import diamnet as jdn
from desco_tpu.models import lrp as jlrp
from desco_tpu.train.checkpoint import _flatten
from desco_tpu.utils import mining as jmining
from desco_tpu_torch import baseline as tbaseline
from desco_tpu_torch.models import baseline_diamnet as tbd
from desco_tpu_torch.models import diamnet as tdn
from desco_tpu_torch.models import lrp as tlrp
from desco_tpu_torch.train.checkpoint import flatten_params, params_from_jax
from desco_tpu_torch.utils import mining as tmining

from test_torch_baselines import (
    H, T, assert_tree_grads_match, close, graph_pair, whole_graph_batches)
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401


# ------------------------------------------------------------------ LRP
@pytest.mark.parametrize("seed", range(3))
def test_lrp_host_arrays_equal_desco_tpu(seed):
    tb, jb, _ = whole_graph_batches(seed)
    jg, tg = graph_pair(seed)
    for a, b in zip(tlrp.lrp_permutations(tg[0]),
                    jlrp.lrp_permutations(jg[0])):
        np.testing.assert_array_equal(a, b)
    cfg_kw = dict(hid_dim=H, num_layers=2, num_tasks=4)
    for p_cap in (0, 1024):
        got = tlrp.lrp_arrays_for_batch(tb, tlrp.LRPConfig(**cfg_kw),
                                        p_cap=p_cap)
        want = jlrp.lrp_arrays_for_batch(jb, jlrp.LRPConfig(**cfg_kw),
                                         p_cap=p_cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "graph"])
def test_lrp_forward_and_gradients_match(batched):
    """apply_lrp_batch over a whole-graph batch and apply_lrp on one
    graph: values and every weight's gradient."""
    tb, jb, _ = whole_graph_batches(5)
    cfg_kw = dict(hid_dim=H, num_layers=2, num_tasks=4)
    jcfg, tcfg = jlrp.LRPConfig(**cfg_kw), tlrp.LRPConfig(**cfg_kw)
    jp = jlrp.init_lrp(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(_flatten(jp))
    wgt = np.random.default_rng(1).standard_normal(4).astype(np.float32)
    if batched:
        arrs = tlrp.lrp_arrays_for_batch(tb, tcfg, p_cap=512)

        def jf(p):
            return jlrp.apply_lrp_batch(p, jcfg, jax_batch(tb),
                                        *map(jnp.asarray, arrs))

        def tf(p):
            return tlrp.apply_lrp_batch(p, tcfg, tb.to("cpu"),
                                        *map(T, arrs))
    else:
        jg, tg = graph_pair(5)
        g = tg[2]
        pn, pa, po = tlrp.lrp_permutations(g)
        degs = g.degrees().astype(np.float32)
        x = np.ones((g.n_nodes, 1), np.float32)
        args = (x, pn, pa, po, degs)

        def jf(p):
            return jlrp.apply_lrp(p, jcfg, *map(jnp.asarray, args),
                                  g.n_nodes)

        def tf(p):
            return tlrp.apply_lrp(p, tcfg, *map(T, args), g.n_nodes)

    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: (jf(p) * wgt).sum()))(jp)
    out = tf(tp)
    close(out.detach(), jf(jp))
    (out * T(wgt)).sum().backward()
    np.testing.assert_allclose(float((out * T(wgt)).sum().detach()),
                               float(want), rtol=1e-4)
    assert_tree_grads_match(tp, jgrads, 8)


# --------------------------------------------------------------- mining
@pytest.mark.parametrize("seed", range(2))
def test_mining_equals_desco_tpu(seed):
    """WL hashes, random BFS neighborhoods, randomized ESU and both
    query miners give desco_tpu's results for the same seed."""
    jg, tg = graph_pair(seed, n_graphs=4, sizes=(6, 12), p=0.4)
    for a, b in zip(tg, jg):
        assert tmining.wl_hash(a) == jmining.wl_hash(b)
        assert tmining.wl_hash(a, anchor=0) == jmining.wl_hash(b, anchor=0)
    assert (tmining.sample_neigh(tg, 4, random.Random(seed))
            == jmining.sample_neigh(jg, 4, random.Random(seed)))
    mine = tmining.enumerate_subgraphs_esu(tg[0], 4, random.Random(seed),
                                           anchored=True)
    theirs = jmining.enumerate_subgraphs_esu(jg[0], 4, random.Random(seed),
                                             anchored=True)
    assert dict(mine) == dict(theirs)
    for fn, kw in ((("mine_queries_esu"), dict(seed=seed)),
                   (("mine_queries_mfinder"), dict(n_samples=200,
                                                   seed=seed))):
        a = getattr(tmining, fn)(tg, {3: 2, 4: 2}, **kw)
        b = getattr(jmining, fn)(jg, {3: 2, 4: 2}, **kw)
        assert len(a) == len(b) > 0
        for qa, qb in zip(a, b):
            assert qa.n_nodes == qb.n_nodes
            np.testing.assert_array_equal(qa.edges, qb.edges)


# ---------------------------------------------------------------- driver
def _carry_desco_tpu_init(kind, cfgs, seed):
    """The port driver's fresh weights replaced by desco_tpu's from the
    same seed (the two packages draw from different generators)."""
    if kind == "LRP":
        (cfg,) = cfgs
        jp = jlrp.init_lrp(jax.random.PRNGKey(seed), jlrp.LRPConfig(
            **dataclasses.asdict(cfg)))
    else:
        tower, dn = cfgs
        jt = jbd.diamnet_tower_config(tower.hidden_dim, tower.layer_num,
                                      tower.conv_type)
        jp = jbd.init_diamnet_pipeline(
            jax.random.PRNGKey(seed), jt,
            jdn.DIAMNetConfig(**dataclasses.asdict(dn)))
    return params_from_jax(_flatten(jp))


def _report_line(text, tag):
    import json

    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{") and f'"baseline": "{tag}"' in ln]
    assert len(lines) == 1, text[-2000:]
    return lines[0]


@pytest.mark.parametrize("kind", ["DIAMNET", "LRP"])
def test_baseline_driver_matches_desco_tpu(kind, tmp_path, monkeypatch,
                                           capsys):
    """``python -m desco_tpu_torch.baseline`` and desco_tpu's root
    baseline.py, one epoch (one Adam step: Syn_24's train split packs into
    one batch) from desco_tpu's initial weights, each with its own data
    root: finite normed MSE and MAE per query size, equal within rtol
    1e-3."""
    monkeypatch.setattr(tbaseline, "init_params", _carry_desco_tpu_init)
    argv = ["--baseline", kind, "--train_dataset", "Syn_24",
            "--test_dataset", "Syn_24", "--epoch_num", "1", "--hidden_dim",
            str(H), "--layer_num", "2", "--query_sizes", "3", "4"]
    assert tbaseline.main(argv + ["--device", "cpu", "--data_root",
                                  str(tmp_path / "t")]) == 0
    ours = _report_line(capsys.readouterr().out, kind)
    assert jbaseline.main(argv + ["--data_root", str(tmp_path / "j")]) == 0
    ref = _report_line(capsys.readouterr().out, kind)
    for key in ("norm_mse", "mae"):
        assert len(ours[key]) == 2 and np.isfinite(ours[key]).all()
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-3,
                                   err_msg=key)


def test_baseline_driver_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbaseline.main(["--epoch_num", "1"])
    args = tbaseline.build_parser().parse_args([])
    assert (args.baseline, args.hidden_dim, args.layer_num, args.mem_init,
            args.batch_size, args.lr) == ("DIAMNET", 64, 3, "mean", 64,
                                          1e-3)


@pytest.mark.parametrize("kind", ["DIAMNET", "LRP"])
def test_reference_script_starts_desco_tpu_from_the_port_weights(kind):
    """tests/baseline_reference.py (chip_smoke.py's desco_tpu figures for
    the drivers) hands desco_tpu's root baseline.py the weights the port's
    driver draws for its seed, under desco_tpu's keys and unchanged."""
    import baseline_reference as ref

    if kind == "LRP":
        jcfg = jlrp.LRPConfig(hid_dim=H, num_layers=2, num_tasks=4)
        template = jlrp.init_lrp(jax.random.PRNGKey(1), jcfg)
        cfgs = (tlrp.LRPConfig(**dataclasses.asdict(jcfg)),)
    else:
        jd = jdn.DIAMNetConfig(pattern_dim=H, graph_dim=H, hidden_dim=H)
        template = jbd.init_diamnet_pipeline(
            jax.random.PRNGKey(1), jbd.diamnet_tower_config(H, 2, "GIN"), jd)
        cfgs = (tbd.diamnet_tower_config(H, 2, "GIN"),
                tdn.DIAMNetConfig(**dataclasses.asdict(jd)))
    got = _flatten(ref._port_weights(kind, template, cfgs))
    want = flatten_params(tbaseline.init_params(kind, cfgs, ref.SEED))
    assert got.keys() == want.keys() == _flatten(template).keys()
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
