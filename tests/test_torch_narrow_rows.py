"""GAT's and PNA's one-column sums in desco_tpu_torch against desco_tpu,
on the CPU: PNA's counts taken from the stream's offsets, GAT's
numerator and denominator as one operand pair (``sorted_segment_sum_pair``
and its one-launch backward), and the towers that use them, packed and
sharded (halo).

Same numpy inputs from a seed and desco_tpu's weights on both sides
(``params_from_jax``), dropout 0, f32. On the CPU the port's pair runs
its plain version (two ``sorted_segment_sum_plain`` calls, two K4
gathers); the kernels are held against it on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 2, 9 and 13).
Tolerances: counts bit for bit (integers below 2^24 are exact in f32);
the pair's sums and their cotangents within 1e-6 of each output's scale
(only the summation order differs: ``index_add_`` against XLA's scatter);
the halo towers' gradients at tests/test_torch_grad.py's bound (rtol
1e-4, atol 1e-6 of each tensor's scale), PNA at one layer and 1e-4 of a
tensor's scale, as tests/test_torch_convs.py holds it (the port takes
PNA's variance in two passes)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from desco_tpu.models import shmp_gnn as jshmp
from desco_tpu.ops.segment import segment_sum as j_segment_sum
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.models import shmp_gnn as tshmp
from desco_tpu_torch.ops import cuda_segment as cs
from desco_tpu_torch.parallel import halo
from desco_tpu_torch.train.checkpoint import params_from_jax

from test_torch_grad import assert_grads_match, flatten_grads
from test_torch_halo import typed_graph
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401
from test_torch_shmp import target_batch

T = torch.from_numpy
N_SHARDS = 4
PAD_KEY = 2 ** 30


def packed_keys(t=6):
    """(keys, n_segments) of a packed target batch's (dst, type) stream,
    as the GAT / PNA aggregators derive them: padding edges (type 63)
    key past n_cap * T."""
    b = target_batch(seed=1)
    keys = (b.edge_dst.astype(np.int64) * t + b.edge_type).astype(np.int32)
    return keys, b.n_cap * t


def halo_shards(seed=4, n=45):
    """The CPU shards of a force_pull partition of a typed sample (6 edge
    types), as the halo GAT / PNA towers run on."""
    s = typed_graph(seed=seed, n=n)
    s.x = np.random.default_rng(seed).standard_normal(
        (s.n_nodes, 1)).astype(np.float32)
    part = halo.partition_typed_graph(
        s.n_nodes, s.node_type, s.x, s.edge_src, s.edge_dst, s.edge_type,
        N_SHARDS, n_types=6, force_pull=True)
    return s, part, halo.place_shards(part, [torch.device("cpu")])


def site_streams(site):
    """[(keys, n_segments)] of one use site: the packed stream, or every
    shard's interior or boundary stream."""
    if site == "packed":
        return [packed_keys()]
    _, _, shards = halo_shards()
    return [(getattr(sh, site).keys.numpy(), sh.n_loc * 6) for sh in shards
            if getattr(sh, site) is not None]


@pytest.mark.parametrize("site", ["packed", "interior", "boundary"])
def test_pna_counts_from_offsets_equal_segment_sum_of_ones(site):
    """``segment_counts`` of a stream's offsets is desco_tpu's
    ``segment_sum(ones, seg, n)`` bit for bit, padding keys dropped and
    empty segments 0, at the packed site and on both halo streams."""
    streams = site_streams(site)
    assert streams
    empty = pad = 0
    for keys, n_seg in streams:
        got = cs.segment_counts(cs.segment_offsets(T(keys), n_seg))
        want = np.asarray(j_segment_sum(
            jnp.ones(keys.shape, jnp.float32), jnp.asarray(keys), n_seg,
            indices_are_sorted=True))
        assert got.dtype == torch.float32 and got.shape == (n_seg,)
        np.testing.assert_array_equal(got.numpy(), want)
        empty += int((want == 0).sum())
        pad += int((keys >= n_seg).sum())
    assert empty > 0 and pad > 0


def pair_case(rng, n_seg=60, e_live=400, k=8, pad=16):
    """A GAT-like sorted stream: keys with empty segments, a run of 50
    edges into one segment and padding keys; p > 0 [E] and z [E, K]."""
    ids = np.sort(np.concatenate([rng.integers(0, n_seg, e_live),
                                  np.full(50, n_seg // 2)]))
    ids = np.concatenate([ids, np.full(pad, PAD_KEY)]).astype(np.int32)
    p = np.exp(rng.standard_normal(len(ids))).astype(np.float32)
    z = rng.standard_normal((len(ids), k)).astype(np.float32)
    return ids, p, z


def test_pair_plain_matches_desco_tpu_num_and_den(rng):
    """GAT's num = segment_sum(p z) and den = segment_sum(p) through the
    pair's autograd Function against desco_tpu's two ``segment_sum``
    calls (shmp_gnn.py:211-214), values and ``jax.vjp`` cotangents."""
    ids, p, z = pair_case(rng)
    n_seg = 60
    gn = rng.standard_normal((n_seg, z.shape[1])).astype(np.float32)
    gd = rng.standard_normal(n_seg).astype(np.float32)

    def jsums(p, z):
        seg = jnp.asarray(ids)
        return (j_segment_sum(p[:, None] * z, seg, n_seg,
                              indices_are_sorted=True),
                j_segment_sum(p, seg, n_seg, indices_are_sorted=True))

    (want_n, want_d), vjp = jax.vjp(jsums, jnp.asarray(p), jnp.asarray(z))
    want_gp, want_gz = vjp((jnp.asarray(gn), jnp.asarray(gd)))
    tp = T(p).requires_grad_(True)
    tz = T(z).requires_grad_(True)
    seg = T(ids)
    num, den = cs.sorted_segment_sum_pair(
        tp[:, None] * tz, tp, seg, n_seg, cs.segment_offsets(seg, n_seg))
    assert num.shape == (n_seg, z.shape[1]) and den.shape == (n_seg,)
    ((num * T(gn)).sum() + (den * T(gd)).sum()).backward()
    for got, want in ((num.detach(), want_n), (den.detach(), want_d),
                      (tp.grad, want_gp), (tz.grad, want_gz)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_pair_plain_equals_two_sums_and_two_gathers(rng):
    """The pair's plain version is the two K1 sums and its backward the
    two K4 gathers, bit for bit, on f32 and on bf16 operands (f32 sums,
    cotangents in the operands' dtype)."""
    ids, p, z = pair_case(rng, k=5)
    n_seg = 60
    seg = T(ids)
    offs = cs.segment_offsets(seg, n_seg)
    g = torch.randn(n_seg, 5, generator=torch.Generator().manual_seed(0))
    g_aux = torch.randn(n_seg, generator=torch.Generator().manual_seed(1))
    for dtype in (torch.float32, torch.bfloat16):
        msgs = (T(p)[:, None] * T(z)).to(dtype)
        aux = T(p).to(dtype)
        num, den = cs.sorted_segment_sum_pair(msgs, aux, seg, n_seg, offs)
        assert num.dtype == den.dtype == torch.float32
        assert torch.equal(num, cs.sorted_segment_sum(msgs, seg, n_seg,
                                                      offs))
        assert torch.equal(den, cs.sorted_segment_sum(
            aux[:, None], seg, n_seg, offs)[:, 0])
        d, d_aux = cs.segment_sum_vjp_pair(g, g_aux, seg, n_seg, dtype)
        assert d.dtype == d_aux.dtype == dtype
        assert torch.equal(d, cs.segment_sum_vjp(g, seg, n_seg, dtype))
        assert torch.equal(d_aux, cs.segment_sum_vjp(
            g_aux[:, None], seg, n_seg, dtype)[:, 0])


class WidthLog:
    """Records the widths of the one-column-capable K1 / K4 entry points
    while a tower runs, so a test can show which sums would launch."""

    def __init__(self, monkeypatch):
        self.k1, self.k4, self.pairs, self.pair_bwds = [], [], 0, 0
        k1_fwd, k4, pair_fwd, pair_bwd = (
            cs._sorted_segment_sum_forward, cs.segment_sum_vjp,
            cs._pair_forward, cs.segment_sum_vjp_pair)

        def k1_spy(msgs, *a):
            self.k1.append(msgs.shape[1])
            return k1_fwd(msgs, *a)

        def k4_spy(g, *a, **kw):
            self.k4.append(g.shape[1])
            return k4(g, *a, **kw)

        def pair_spy(*a):
            self.pairs += 1
            return pair_fwd(*a)

        def pair_bwd_spy(*a, **kw):
            self.pair_bwds += 1
            return pair_bwd(*a, **kw)

        monkeypatch.setattr(cs, "_sorted_segment_sum_forward", k1_spy)
        monkeypatch.setattr(cs, "segment_sum_vjp", k4_spy)
        monkeypatch.setattr(cs, "_pair_forward", pair_spy)
        monkeypatch.setattr(cs, "segment_sum_vjp_pair", pair_bwd_spy)


def tower(conv, layers, hidden=8, seed=2):
    kw = dict(layer_num=layers, hidden_dim=hidden, conv_type=conv)
    jcfg = jshmp.neighborhood_target_config(**kw)
    jparams = jshmp.init_shmp(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jparams), (tshmp.neighborhood_target_config(**kw),
                             params_from_jax(_flatten(jparams)))


@pytest.mark.parametrize("where", ["packed", "halo"])
@pytest.mark.parametrize("conv", ["GAT", "PNA"])
def test_no_one_column_sum_at_gat_and_pna_sites(monkeypatch, conv, where):
    """Through a forward and backward of the tower core, no K1 sum and no
    K4 gather of one column is called at a GAT or PNA site: GAT sums and
    differentiates its numerator and denominator as one pair per layer
    and stream, PNA counts from the offsets."""
    layers = 2
    s, part, shards = halo_shards()
    _, (tcfg, tparams) = tower(conv, layers)
    log = WidthLog(monkeypatch)
    if where == "packed":
        [b] = pack_samples([s], *auto_capacities([s], g_cap=1))
        out = tshmp.apply_shmp_core(tparams, tcfg, b.to("cpu"))
        streams = 1
    else:
        out = torch.cat(halo.halo_shmp_core(tparams, tcfg, shards))
        streams = sum(1 + (sh.boundary is not None) for sh in shards)
    out.sum().backward()
    assert all(k > 1 for k in log.k1 + log.k4)
    want = layers * streams if conv == "GAT" else 0
    assert (log.pairs, log.pair_bwds) == (want, want)
    # PNA: K1 on the sum and the squared deviations, K4 behind both, and
    # the mean's K4 gather with K1 behind it; GAT: the pair alone
    n_pna = 3 * layers * streams if conv == "PNA" else 0
    assert (len(log.k1), len(log.k4)) == (n_pna, n_pna)


@pytest.mark.parametrize("conv", ["GAT", "PNA"])
def test_halo_tower_gradients_match_desco_tpu(conv):
    """The halo GAT / PNA core's parameter gradients of sum(core * w)
    against ``jax.grad`` of desco_tpu's packed ``apply_shmp_core`` on the
    same whole-graph sample (the same function: every (dst, type)
    statistic is local at a pull-only partition's dst owner)."""
    layers = 1 if conv == "PNA" else 2
    s, part, shards = halo_shards()
    (jcfg, jparams), (tcfg, tparams) = tower(conv, layers)
    [b] = pack_samples([s], *auto_capacities([s], g_cap=1))
    w = np.random.default_rng(6).standard_normal(
        (s.n_nodes, tcfg.post_input_dim)).astype(np.float32)
    jb = jax_batch(b)
    jgrads = jax.grad(lambda p: (jshmp.apply_shmp_core(p, jcfg, jb)
                                 [:s.n_nodes] * jnp.asarray(w)).sum())(
        jparams)
    tparams.requires_grad_(True)
    outs = halo.halo_shmp_core(tparams, tcfg, shards)
    got = torch.cat([o[:int(r[1] - r[0])]
                     for o, r in zip(outs, part.node_range)])
    (got * T(w)).sum().backward()
    if conv == "PNA":
        grads = flatten_grads(tparams)
        for key, want in _flatten(jgrads).items():
            scale = float(np.abs(want).max())
            assert np.abs(grads[key] - want).max() <= 1e-4 * scale, key
    else:
        assert_grads_match(tparams, jgrads, min_nonzero=5)
