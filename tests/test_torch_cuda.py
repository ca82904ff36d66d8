"""desco_tpu_torch CUDA kernels against their plain PyTorch versions, on
the GPU (``cuda`` marker; they skip without one — a CUDA kernel has no
CPU mode). This file imports no JAX and needs nothing from
tests/conftest.py (which imports JAX), so it runs on a GPU machine
without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance rtol 1e-5, atol 1e-5 * max|ref|: float32 on both sides, only
the summation order differs (the plain version's index_add_ uses
atomics); K2 and K3 multiply on the tensor cores in split TF32, which
keeps f32 accuracy. Gradients through the kernels (K3 behind K2, K4
behind K1) are held against autograd of the plain forward, f32 against
f32, at rtol 1e-4 of each tensor's scale: two reductions and two matmuls
deep. On bf16 rows both sides accumulate the same bf16 values in f32 and
multiply exactly (bf16 is exact in TF32), so the same tolerance holds,
except that K3's bf16 dx and dW are f32 results rounded to bf16 (one
bf16 step, rtol 2^-7); K4's bf16 result and the K5 probe's bit patterns
must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

from desco_tpu_torch.ops import cuda_segment as cs

T = torch.from_numpy
BF = torch.bfloat16


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def sorted_stream(rng, n_seg, e_live, k, pad=64, neg=0):
    seg = np.sort(rng.integers(0, n_seg, e_live))
    seg = np.concatenate([np.full(neg, -1), seg, np.full(pad, 2 ** 30)])
    msgs = rng.standard_normal((len(seg), k)).astype(np.float32)
    return msgs, seg.astype(np.int32)


def typed_case(rng, n, t, h, k, e, pad=64):
    """(x, src, dst, typ, keys, w): a (dst,type)-sorted edge stream with
    desco_tpu's padding layout (pad keys (n-1)*T+63, src = dst = the zero
    pad node n-1, type 63)."""
    x = rng.standard_normal((n, h)).astype(np.float32)
    x[n - 1] = 0.0
    dst = rng.integers(0, n - 1, e)
    typ = rng.integers(0, t, e)
    src = rng.integers(0, n - 1, e)
    keys = dst * t + typ
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(pad, (n - 1) * t + 63)])
    src = np.concatenate([src[order], np.full(pad, n - 1)])
    dst = np.concatenate([dst[order], np.full(pad, n - 1)])
    typ = np.concatenate([typ[order], np.full(pad, 63)])
    w = (rng.standard_normal((t, h, k)) * 0.1).astype(np.float32)
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return x, i32(src), i32(dst), i32(typ), i32(keys), w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 128, 576])
def test_k1_kernel_matches_plain_on_gpu(rng, cuda_device, k):
    msgs, seg = sorted_stream(rng, 700, 5000, k, neg=3)
    m, s = T(msgs).to(cuda_device), T(seg).to(cuda_device)
    with torch.inference_mode():
        out = cs.sorted_segment_sum(m, s, 700, cs.segment_offsets(s, 700))
        ref = cs.sorted_segment_sum_plain(m, s, 700)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def close(out, ref, rtol=1e-5):
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5 * float(ref.float().abs().max()))


# (n, h, k, t, live edges): the widths of chip_smoke.py's edge cases;
# n = 1000 and 333 are no multiple of the 32-row tile
K2_CASES = [(1000, 64, 64, 6, 6000), (1000, 64, 128, 2, 6000),
            (1000, 64, 33, 3, 6000), (333, 16, 33, 3, 999),
            (333, 64, 64, 6, 900)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,k,t,e", K2_CASES)
def test_k2_kernel_matches_plain_on_gpu(rng, cuda_device, n, h, k, t, e):
    x, src, _, _, keys, w = typed_case(rng, n, t, h, k, e)
    args = [T(a).to(cuda_device) for a in (x, src, keys, w)]
    before = cs.fused_typed_transform_aggregate.launches
    with torch.inference_mode():
        out = cs.fused_typed_transform_aggregate(*args[:3], args[3], t, n)
        ref = cs.fused_typed_transform_aggregate_plain(
            *args[:3], args[3], t, n)
    torch.cuda.synchronize()
    assert cs.fused_typed_transform_aggregate.launches == before + 1
    close(out, ref)


def dead_tile_case(rng, n=200, t=6, h=64, k=64):
    """A stream whose destinations and sources avoid rows [32, 96): two
    whole 32-row tiles without a live edge, in both directions."""
    x, src, dst, typ, keys, w = typed_case(rng, n, t, h, k, 1500)
    live = typ < t
    dst = np.where(live & (dst >= 32) & (dst < 96), dst + 64, dst)
    src = np.where(live & (src >= 32) & (src < 96), src + 64, src)
    keys = np.where(live, dst * t + typ, keys)
    order = np.argsort(keys, kind="stable")
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return x, i32(src[order]), i32(keys[order]), w


@pytest.mark.cuda
def test_k2_k3_tiles_without_live_edges(rng, cuda_device):
    n, t = 200, 6
    x, src, keys, w = dead_tile_case(rng, n, t)
    perm = bwd_perm_of(src, keys, t, n)
    xd, sd, kd, wd = (T(a).to(cuda_device) for a in (x, src, keys, w))
    st = cs.typed_streams(sd, kd, t, n, n, T(perm).to(cuda_device))
    tiles = cs.tile_edge_ranges(st.fwd_toffs, n, t)
    assert bool((tiles[1:3, 0] == tiles[1:3, 1]).all())  # tiles 1, 2 dead
    btiles = cs.tile_edge_ranges(st.bwd_offs, n, t)
    assert bool((btiles[1:3, 0] == btiles[1:3, 1]).all())
    g = T(rng.standard_normal((n, 64)).astype(np.float32)).to(cuda_device)
    with torch.inference_mode():
        out = cs.fused_typed_transform_aggregate(xd, sd, kd, wd, t, n,
                                                 streams=st)
        dx, dw = cs.typed_aggregate_bwd(g, xd, wd, st)
    torch.cuda.synchronize()
    close(out, cs.fused_typed_transform_aggregate_plain(xd, sd, kd, wd, t, n))
    assert float(out[32:96].abs().max()) == 0.0
    dx_ref, dw_ref = cs.typed_aggregate_bwd_plain(g, xd, wd, st)
    close(dx, dx_ref)
    close(dw, dw_ref)
    assert float(dx[32:96].abs().max()) == 0.0


def bwd_perm_of(src, keys, t, n):
    """Edge slots in (src, type) order, dead edges last."""
    return np.lexsort((keys % t, src, keys >= n * t)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 128])
def test_k4_kernel_matches_plain_on_gpu(rng, cuda_device, k):
    _, seg = sorted_stream(rng, 700, 5000, k, neg=3)
    g = rng.standard_normal((700, k)).astype(np.float32)
    gd, s = T(g).to(cuda_device), T(seg).to(cuda_device)
    before = cs.segment_sum_vjp.launches
    out = cs.segment_sum_vjp(gd, s, 700)
    # a strided cotangent (autograd hands such over) is made contiguous
    wide = torch.cat([gd, gd], dim=1)[:, :k]
    out2 = cs.segment_sum_vjp(wide, s, 700)
    torch.cuda.synchronize()
    assert cs.segment_sum_vjp.launches == before + 2
    ref = cs.segment_sum_vjp_plain(gd, s, 700)
    assert torch.equal(out, ref) and torch.equal(out2, ref)  # a copy
    assert float(out[-64:].abs().max()) == 0.0  # pad keys get zero


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,k,t,e", K2_CASES)
def test_k3_kernel_matches_plain_on_gpu(rng, cuda_device, n, h, k, t, e):
    x, src, _, _, keys, w = typed_case(rng, n, t, h, k, e)
    perm = bwd_perm_of(src, keys, t, n)
    st = cs.typed_streams(T(src).to(cuda_device), T(keys).to(cuda_device),
                          t, n, n, T(perm).to(cuda_device))
    xd, wd = T(x).to(cuda_device), T(w).to(cuda_device)
    g = T(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    before = cs.typed_aggregate_bwd.launches
    dx, dw = cs.typed_aggregate_bwd(g, xd, wd, st)
    torch.cuda.synchronize()
    assert cs.typed_aggregate_bwd.launches == before + 1
    dx_ref, dw_ref = cs.typed_aggregate_bwd_plain(g, xd, wd, st)
    close(dx, dx_ref)
    close(dw, dw_ref)


def typed_pair(rng, dev, n, h, k, t, e, dtype):
    """(x, w, streams with a backward permutation, g) on the card."""
    x, src, _, _, keys, w = typed_case(rng, n, t, h, k, e)
    st = cs.typed_streams(T(src).to(dev), T(keys).to(dev), t, n, n,
                          T(bwd_perm_of(src, keys, t, n)).to(dev))
    g = T(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
    return (T(x).to(dev).to(dtype), T(w).to(dev).to(dtype), st, g)


def run_k2_k3(x, w, st):
    with torch.inference_mode():
        out = cs.fused_typed_transform_aggregate(
            x, st.edge_src, st.keys, w, st.n_types, st.n_nodes, streams=st)
        dx, dw = cs.typed_aggregate_bwd(g_of(st, w), x, w, st)
    torch.cuda.synchronize()
    return out, dx, dw


def g_of(st, w):
    gen = torch.Generator(device=w.device).manual_seed(st.n_types)
    return torch.randn(st.n_nodes, w.shape[2], device=w.device,
                       generator=gen)


# (n, h, k, t, live edges): more types than one tile's buffers hold in
# shared memory (K2' takes at most 11 at H = K = 64 in f32, K3' 21):
# T = 12 and 22 just past those, 13 odd, 33 the order-4 typing; widths
# 128 (two types per K2' chunk) and odd ones
MANY_TYPE_CASES = [(1000, 64, 64, 12, 8000), (1000, 64, 64, 13, 8000),
                   (1000, 64, 64, 22, 8000), (2000, 64, 64, 33, 16000),
                   (500, 128, 128, 33, 4000), (333, 16, 33, 33, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,k,t,e", MANY_TYPE_CASES)
def test_k2_k3_in_type_chunks_match_plain_on_gpu(rng, cuda_device, n, h, k,
                                                 t, e, dtype):
    """K2' and K3' past their shared memory: the types run in chunks,
    against the plain versions (bf16 dx / dW one bf16 step), and two runs
    are bit-equal."""
    x, w, st, g = typed_pair(rng, cuda_device, n, h, k, t, e, dtype)
    assert cs.chunk_types(dtype, h, k, t) <= t
    if (h, k, dtype) == (64, 64, torch.float32):
        assert cs.chunk_types(dtype, h, k, t) < t  # K2' needs chunks here
        assert (cs.chunk_types(dtype, h, k, t, backward=True) < t) == (t > 21)
    out, dx, dw = run_k2_k3(x, w, st)
    close(out, cs.fused_typed_transform_aggregate_plain(
        x, st.edge_src, st.keys, w, t, n))
    dx_ref, dw_ref = cs.typed_aggregate_bwd_plain(g_of(st, w), x, w, st)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    close(dx, dx_ref, rtol)
    close(dw, dw_ref, rtol)
    for a, b in zip((out, dx, dw), run_k2_k3(x, w, st)):
        assert torch.equal(a, b)


# (n, h, k, live edges) at one edge type, the DIAMNet graph tower's: every
# (dst, type) run is a whole destination row, the W ring holds one matrix
# and the chunk loop runs once; widths 64 (the tower's) and odd ones
ONE_TYPE_CASES = [(1000, 64, 64, 8000), (1000, 64, 64, 0),
                  (333, 33, 17, 2000), (129, 64, 128, 600)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,k,e", ONE_TYPE_CASES)
def test_k2_k3_at_one_edge_type_match_plain_on_gpu(rng, cuda_device, n, h,
                                                   k, e, dtype):
    """K2' and K3' at T = 1 against the plain versions (bf16 dx / dW one
    bf16 step), and two runs bit-equal; one chunk of one type."""
    x, w, st, _ = typed_pair(rng, cuda_device, n, h, k, 1, e, dtype)
    assert cs.chunk_types(dtype, h, k, 1) == 1
    assert cs.chunk_types(dtype, h, k, 1, backward=True) == 1
    out, dx, dw = run_k2_k3(x, w, st)
    assert tuple(dw.shape) == (1, h, k)
    close(out, cs.fused_typed_transform_aggregate_plain(
        x, st.edge_src, st.keys, w, 1, n))
    dx_ref, dw_ref = cs.typed_aggregate_bwd_plain(g_of(st, w), x, w, st)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    close(dx, dx_ref, rtol)
    close(dw, dw_ref, rtol)
    for a, b in zip((out, dx, dw), run_k2_k3(x, w, st)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,cap", [(6, 2), (6, 4), (33, 5)])
def test_type_chunks_change_no_bit(rng, cuda_device, t, cap, dtype):
    """The chunked path sums the types in the order of the whole one: a
    cap on the types per chunk gives bit-equal out, dx and dW."""
    x, w, st, _ = typed_pair(rng, cuda_device, 1000, 64, 64, t, 9000, dtype)
    whole = run_k2_k3(x, w, st)
    cs.set_chunk_cap(cap)
    try:
        assert cs.chunk_types(dtype, 64, 64, t) <= cap
        assert cs.chunk_types(dtype, 64, 64, t, backward=True) <= cap
        chunked = run_k2_k3(x, w, st)
    finally:
        cs.set_chunk_cap(0)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_perm", [True, False])
def test_kernel_gradients_match_plain_autograd(rng, cuda_device, with_perm):
    """K2 under grad: backward through K3 (with a permutation) or the
    legacy path (without) equals autograd of the plain forward."""
    n, t, k = 500, 6, 64
    x, src, _, _, keys, w = typed_case(rng, n, t, 64, k, 3000)
    perm = T(bwd_perm_of(src, keys, t, n)).to(cuda_device)
    sd, kd = T(src).to(cuda_device), T(keys).to(cuda_device)
    grads = []
    for fn in (cs.fused_typed_transform_aggregate,
               cs.fused_typed_transform_aggregate_plain):
        xs = T(x).to(cuda_device).requires_grad_()
        ws = T(w).to(cuda_device).requires_grad_()
        kw = ({"bwd_perm": perm} if with_perm and
              fn is cs.fused_typed_transform_aggregate else {})
        before = cs.typed_aggregate_bwd.launches
        (fn(xs, sd, kd, ws, t, n, **kw) ** 2).sum().backward()
        if kw:
            assert cs.typed_aggregate_bwd.launches == before + 1
        grads.append((xs.grad, ws.grad))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_k1_gradient_runs_k4_on_gpu(rng, cuda_device):
    msgs, seg = sorted_stream(rng, 50, 300, 64)
    m = T(msgs).to(cuda_device).requires_grad_()
    s = T(seg).to(cuda_device)
    wgt = torch.randn(50, 64, device=cuda_device)
    before = cs.segment_sum_vjp.launches
    out = cs.sorted_segment_sum(m, s, 50, cs.segment_offsets(s, 50))
    (out * wgt).sum().backward()
    torch.cuda.synchronize()
    assert cs.segment_sum_vjp.launches == before + 1
    assert torch.equal(m.grad, cs.segment_sum_vjp_plain(wgt, s, 50))


@pytest.mark.cuda
def test_unsorted_bwd_perm_is_refused(rng, cuda_device):
    x, src, _, _, keys, w = typed_case(rng, 64, 2, 8, 8, 100)
    ident = torch.arange(len(keys), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="order"):
        cs.typed_streams(T(src).to(cuda_device), T(keys).to(cuda_device),
                         2, 64, 64, ident)


@pytest.mark.cuda
def test_wrapper_counts_launches_and_checks_inputs(rng, cuda_device):
    msgs, seg = sorted_stream(rng, 50, 300, 64)
    m, s = T(msgs).to(cuda_device), T(seg).to(cuda_device)
    before = cs.sorted_segment_sum.launches
    with torch.inference_mode():
        offs = cs.segment_offsets(s, 50)
        cs.sorted_segment_sum(m, s, 50, offs)
        assert cs.sorted_segment_sum.launches == before + 1
        with pytest.raises(ValueError, match="int32"):
            cs.sorted_segment_sum(m, s.long(), 50, offs)
        with pytest.raises(ValueError, match="contiguous"):
            cs.sorted_segment_sum(m.t().contiguous().t(), s, 50, offs)
        with pytest.raises(ValueError, match="CUDA"):
            cs.sorted_segment_sum(m, T(seg), 50, offs)


# ------------------------------------------------------------- bf16 rows


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 128, 576])
def test_k1_bf16_kernel_matches_plain_on_gpu(rng, cuda_device, k):
    msgs, seg = sorted_stream(rng, 700, 5000, k, neg=3)
    m, s = T(msgs).to(cuda_device).to(BF), T(seg).to(cuda_device)
    before = cs.sorted_segment_sum.launches_bf16
    with torch.inference_mode():
        out = cs.sorted_segment_sum(m, s, 700, cs.segment_offsets(s, 700))
        ref = cs.sorted_segment_sum_plain(m, s, 700)
    torch.cuda.synchronize()
    assert cs.sorted_segment_sum.launches_bf16 == before + 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,k,t,e", K2_CASES)
def test_k2_k3_bf16_kernels_match_plain_on_gpu(rng, cuda_device, n, h, k, t,
                                               e):
    x, src, _, _, keys, w = typed_case(rng, n, t, h, k, e)
    xd, wd = (T(a).to(cuda_device).to(BF) for a in (x, w))
    sd, kd = T(src).to(cuda_device), T(keys).to(cuda_device)
    st = cs.typed_streams(sd, kd, t, n, n,
                          T(bwd_perm_of(src, keys, t, n)).to(cuda_device))
    before = (cs.fused_typed_transform_aggregate.launches_bf16,
              cs.typed_aggregate_bwd.launches_bf16)
    with torch.inference_mode():
        out = cs.fused_typed_transform_aggregate(xd, sd, kd, wd, t, n)
        ref = cs.fused_typed_transform_aggregate_plain(xd, sd, kd, wd, t, n)
        g = T(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
        dx, dw = cs.typed_aggregate_bwd(g, xd, wd, st)
        dx_ref, dw_ref = cs.typed_aggregate_bwd_plain(g, xd, wd, st)
    torch.cuda.synchronize()
    assert (cs.fused_typed_transform_aggregate.launches_bf16,
            cs.typed_aggregate_bwd.launches_bf16) == (before[0] + 1,
                                                      before[1] + 1)
    assert out.dtype == torch.float32
    assert dx.dtype == dw.dtype == BF  # the primal's dtype
    close(out, ref)
    close(dx, dx_ref, 2.0 ** -7)
    close(dw, dw_ref, 2.0 ** -7)
    with pytest.raises(ValueError, match="one type"):
        cs.fused_typed_transform_aggregate(xd, sd, kd, wd.float(), t, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 66, 128, 576])
def test_k4_bf16_kernel_equals_plain_on_gpu(rng, cuda_device, k):
    _, seg = sorted_stream(rng, 700, 5000, k, neg=3)
    g = T(rng.standard_normal((700, k)).astype(np.float32)).to(cuda_device)
    s = T(seg).to(cuda_device)
    out = cs.segment_sum_vjp(g, s, 700, dtype=BF)
    torch.cuda.synchronize()
    assert out.dtype == BF
    assert torch.equal(out, cs.segment_sum_vjp_plain(g, s, 700, BF))
    # behind K1 under grad: the cotangent takes the messages' dtype
    m = torch.randn(len(seg), k, device=cuda_device).to(BF).requires_grad_()
    out2 = cs.sorted_segment_sum(m, s, 700, cs.segment_offsets(s, 700))
    (out2 * g).sum().backward()
    assert m.grad.dtype == BF and torch.equal(m.grad, out)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 128])
def test_probe_variants_match_plain_on_gpu(rng, cuda_device, k):
    from desco_tpu_torch.tools import segsum_inner_ablation as probe

    msgs, seg = sorted_stream(rng, 700, 5000 - 64, k)  # 5000 rows
    m, s = T(msgs).to(cuda_device).to(BF), T(seg).to(cuda_device)
    for name, fn in probe.VARIANTS.items():
        before = fn.launches
        out = fn(m, s, 333)  # run = 16: the last warps run dry
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = probe.PLAIN[name](m, s, 333)
        if name == "stream":
            assert torch.equal(out[1], ref[1])
            out, ref = out[0], ref[0]
        if name == "full":
            assert torch.equal(out, cs.sorted_segment_sum(
                m, s, 333, cs.segment_offsets(s, 333)))
        if name in ("noacc", "stream"):
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5,
                                       atol=1e-5 * float(ref.abs().max()))


# ------------------------------------------------- the gather-fused K1
def gossip_samples(rng, n_graphs=6, n_queries=29):
    """Samples shaped like the gossip stage's: both directions of every
    edge, type 0 where src < dst and 1 where src > dst, x and node_y
    [k, n_queries] counts; some nodes have no edge at all."""
    from desco_tpu_torch.batch.packed import GraphSample

    out = []
    for _ in range(n_graphs):
        k = int(rng.integers(8, 30))
        m = int(rng.integers(k // 2, 2 * k))
        u, v = rng.integers(0, k, m), rng.integers(0, k, m)
        u, v = u[u != v], v[u != v]
        src = np.concatenate([u, v]).astype(np.int32)
        dst = np.concatenate([v, u]).astype(np.int32)
        out.append(GraphSample(
            node_type=np.zeros(k, np.int32),
            x=rng.uniform(0, 5, (k, n_queries)).astype(np.float32),
            edge_src=src, edge_dst=dst,
            edge_type=(src > dst).astype(np.int32),
            node_y=rng.uniform(0, 5, (k, n_queries)).astype(np.float32)))
    return out


def gather_streams(rng, dev, n, t, k, e, pad=64, long_dst=0, long_src=0):
    """x [n, k] and the ``TypedStreams`` (backward streams derived on the
    card) of a (dst,type)-sorted stream in desco_tpu's padding layout;
    ``long_dst`` / ``long_src`` more edges into / out of node 7."""
    x, src, dst, typ, _, _ = typed_case(rng, n, t, k, 1, e, pad=0)
    extra_d = np.concatenate([np.full(long_dst, 7),
                              rng.integers(0, n - 1, long_src)])
    extra_s = np.concatenate([rng.integers(0, n - 1, long_dst),
                              np.full(long_src, 7)])
    dst = np.concatenate([dst, extra_d])
    src = np.concatenate([src, extra_s])
    keys = dst * t + np.concatenate([typ, rng.integers(0, t, len(extra_d))])
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(pad, (n - 1) * t + 63)])
    src = np.concatenate([src[order], np.full(pad, n - 1)])
    st = cs.typed_streams(T(src.astype(np.int32)).to(dev),
                          T(keys.astype(np.int32)).to(dev), t, n, n)
    return T(x).to(dev), cs.ensure_backward_streams(st)


# (n, t, k, live edges, extra): odd K, K = 1 (the direction degrees), two
# lane groups (K = 16), K = 576 over few segments, long segments both
# ways, all padding, an empty stream
GATHER_CASES = [
    (700, 2, 128, 4000, {}), (300, 6, 64, 2000, {}), (300, 3, 33, 999, {}),
    (500, 2, 1, 3000, {}), (200, 2, 16, 1500, {}), (5, 2, 576, 3000, {}),
    (500, 2, 128, 900, {"long_dst": 5000, "long_src": 5000}),
    (129, 2, 64, 0, {"pad": 512}), (40, 2, 128, 0, {"pad": 0}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,t,k,e,extra", GATHER_CASES)
def test_gather_segsum_matches_plain_on_gpu(rng, cuda_device, n, t, k, e,
                                            extra, dtype):
    """Forward against ``index_select`` + ``segment_sum`` (rtol 1e-5), dx
    against autograd of it (f32 rtol 1e-5; bf16 dx is an f32 sum rounded
    to bf16: one step, 2^-7); two backward runs bit-equal."""
    x, st = gather_streams(rng, cuda_device, n, t, k, e, **extra)
    x = x.to(dtype)
    g = T(rng.standard_normal((n * t, k)).astype(np.float32)).to(cuda_device)
    before = (cs.gather_segment_sum.launches,
              cs.gather_segment_sum_bwd.launches)
    with torch.inference_mode():
        out = cs.gather_segment_sum(x, st)
        dx = cs.gather_segment_sum_bwd(g, st, dtype)
        dx2 = cs.gather_segment_sum_bwd(g, st, dtype)
    torch.cuda.synchronize()
    assert (cs.gather_segment_sum.launches,
            cs.gather_segment_sum_bwd.launches) == (before[0] + 1,
                                                    before[1] + 2)
    assert out.dtype == torch.float32 and dx.dtype == dtype
    assert torch.equal(dx, dx2)
    close(out, cs.gather_segment_sum_plain(x, st))
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    close(dx, cs.gather_segment_sum_bwd_plain(g, st, dtype), rtol)
    # under autograd: the backward is the kernel, never index_add_
    xg = x.detach().clone().requires_grad_()
    (cs.gather_segment_sum(xg, st) * g).sum().backward()
    assert cs.gather_segment_sum_bwd.launches == before[1] + 3
    assert torch.equal(xg.grad, dx)


def edge_order_sum(x, rows, offs):
    """The edge-order f32 sum of x[rows[e]] (rows None: x[e]) over each
    segment [offs[r], offs[r+1]), in numpy: ((0 + x_0) + x_1) + ..., the
    order of K1's wide layout (rows of more than 16 elements)."""
    x = np.asarray(x, np.float32)
    lo, hi = offs[:-1].astype(np.int64), offs[1:].astype(np.int64)
    out = np.zeros((len(lo), x.shape[1]), np.float32)
    for j in range(int((hi - lo).max(initial=0))):
        m = hi - lo > j
        e = lo[m] + j
        out[m] = out[m] + x[e if rows is None else rows[e]]
    return out


def k1_order_sum(x, rows, offs):
    """K1's sum in its layout's order: edge order above 16 elements, the
    narrow fold order at or below."""
    from chip_smoke import narrow_order_sum

    order = edge_order_sum if x.shape[1] > 16 else narrow_order_sum
    return order(x, rows, offs)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 16, 33, 64, 128, 576])
def test_k1_identity_equals_probe_full_and_edge_order(rng, cuda_device, k):
    """K1 on the identity stream (graph pooling) is the probe's ``full``
    variant bit for bit, and for rows of more than 16 elements it is the
    edge-order f32 sum of each element (the order before the column
    split), so f32 rows give exactly the cumulative sum's differences; at
    16 elements or fewer it is the sum in the narrow layout's fold order,
    bit for bit."""
    from desco_tpu_torch.tools import segsum_inner_ablation as probe

    msgs, seg = sorted_stream(rng, 300, 3000, k)
    m, s = T(msgs).to(cuda_device).to(BF), T(seg).to(cuda_device)
    with torch.inference_mode():
        offs = cs.segment_offsets(s, 300)
        assert torch.equal(cs.sorted_segment_sum(m, s, 300, offs),
                           probe.probe_full(m, s, 300))
        mf = T(msgs).to(cuda_device)
        out = cs.sorted_segment_sum(mf, s, 300, offs)
    assert torch.equal(out.cpu(), T(k1_order_sum(
        msgs, None, offs.cpu().numpy())))


def narrow_stream(rng, n_seg, e_live, k, n_rows=0):
    """A sorted stream for the narrow layout: short segments, empty ones,
    one of 5000 edges and one of 40 (both past the 32 / lanes edges a lane
    sums alone, so summed by their whole warp), three negative keys first and
    64 padding keys last; x [E, k] (or [n_rows, k] with random rows, the
    gather)."""
    ids = np.sort(np.concatenate([rng.integers(0, n_seg - 100, e_live),
                                  np.full(5000, n_seg // 7),
                                  np.full(40, n_seg - 50)]))
    seg = np.concatenate([np.full(3, -1), ids, np.full(64, 2 ** 30)])
    x = rng.standard_normal((n_rows or len(seg), k)).astype(np.float32)
    rows = (rng.integers(0, n_rows, len(seg)).astype(np.int32) if n_rows
            else None)
    return x, rows, seg.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("gather", [False, True], ids=["identity", "gather"])
@pytest.mark.parametrize("k", list(range(1, 17)))
def test_k1_narrow_rows_are_fold_order_sums_on_gpu(rng, cuda_device, k,
                                                   gather, dtype):
    """Rows of 1-16 elements (K1's narrow layout, a group of lanes per
    segment), identity rows and gathered ones: bit for bit the f32 sum of
    the (up-cast) rows in the layout's fold order, computed on the CPU,
    whether a segment was summed by its lanes or by its whole warp; equal
    over two runs; within the plain version's tolerance; empty segments
    0, negative and padding keys never read."""
    n_seg = 700
    x, rows, seg = narrow_stream(rng, n_seg, 3000, k,
                                 n_rows=500 if gather else 0)
    xd = T(x).to(cuda_device).to(dtype)
    sd = T(seg).to(cuda_device)
    rd = None if rows is None else T(rows).to(cuda_device)
    with torch.inference_mode():
        offs = cs.segment_offsets(sd, n_seg)
        outs = [torch.empty(n_seg, k, device=cuda_device) for _ in range(2)]
        for out in outs:
            cs.launch_k1(xd, offs, n_seg, out, rows=rd)
        if not gather:
            before = cs.sorted_segment_sum.launches
            assert torch.equal(cs.sorted_segment_sum(xd, sd, n_seg, offs),
                               outs[0])
            assert cs.sorted_segment_sum.launches == before + 1
        ref = cs.gather_rows_segment_sum_plain(xd, rd, offs, n_seg)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    close(outs[0], ref)
    o = offs.cpu().numpy()
    assert torch.equal(outs[0].cpu(), T(k1_order_sum(
        xd.float().cpu().numpy(), rows, o)))
    assert int((o[1:] - o[:-1] == 0).sum()) > 0 and o[0] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 16, 33, 64, 128])
def test_k1_k4_pairs_equal_two_launches_on_gpu(rng, cuda_device, k, dtype):
    """GAT's operand pair: one K1 launch (two at K <= 16) sums the rows
    and the one-column operand, bit-equal to K1 on each alone (the same
    layouts' sums), and
    one K4 launch writes both cotangents, equal to K4 on each alone;
    under autograd the backward is that launch. Each pair counts one
    launch on its own counter; mixed dtypes raise."""
    n_seg = 700
    x, _, seg = narrow_stream(rng, n_seg, 3000, k)
    m = T(x).to(cuda_device).to(dtype)
    a = T(np.exp(x[:, 0])).to(cuda_device).to(dtype)
    s = T(seg).to(cuda_device)
    offs = cs.segment_offsets(s, n_seg)
    g = torch.randn(n_seg, k, device=cuda_device)
    g_aux = torch.randn(n_seg, 2, device=cuda_device)[:, 0]  # strided
    before = (cs.sorted_segment_sum_pair.launches,
              cs.segment_sum_vjp_pair.launches)
    with torch.inference_mode():
        num, den = cs.sorted_segment_sum_pair(m, a, s, n_seg, offs)
        d, d_aux = cs.segment_sum_vjp_pair(g, g_aux, s, n_seg, dtype)
        want = (cs.sorted_segment_sum(m, s, n_seg, offs),
                cs.sorted_segment_sum(a[:, None], s, n_seg, offs)[:, 0],
                cs.segment_sum_vjp(g, s, n_seg, dtype),
                cs.segment_sum_vjp(g_aux[:, None].contiguous(), s, n_seg,
                                   dtype)[:, 0])
    torch.cuda.synchronize()
    assert (cs.sorted_segment_sum_pair.launches,
            cs.segment_sum_vjp_pair.launches) == (before[0] + 1,
                                                  before[1] + 1)
    for got, ref in zip((num, den, d, d_aux), want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    mg, ag = m.clone().requires_grad_(), a.clone().requires_grad_()
    num2, den2 = cs.sorted_segment_sum_pair(mg, ag, s, n_seg, offs)
    ((num2 * g).sum() + (den2 * g_aux).sum()).backward()
    assert cs.segment_sum_vjp_pair.launches == before[1] + 2
    assert torch.equal(mg.grad, d) and torch.equal(ag.grad, d_aux)
    other = torch.float32 if dtype == BF else BF
    with pytest.raises(ValueError):
        cs.sorted_segment_sum_pair(m, a.to(other), s, n_seg, offs)


@pytest.mark.cuda
def test_gossip_loss_runs_the_gather_fused_kernel(cuda_device):
    """On the card the gossip loss runs the gather-fused K1 (1 + 4 x 29
    forward with the checkpoint's recomputation, 29 backward), never K1 on
    [E, K] messages or K4; a batch without a permutation gets it derived
    on the card, equal to pack_samples'."""
    from desco_tpu_torch.batch.packed import pack_samples
    from desco_tpu_torch.models import gossip as gm
    from desco_tpu_torch.models.shmp_gnn import batch_typed_streams

    samples = gossip_samples(np.random.default_rng(0))
    b = pack_samples(samples, 256, 2048, 8, n_queries=29)[0]
    with_perm = b.to(cuda_device, training=True)
    without = b.to(cuda_device)
    without.node_y = with_perm.node_y
    st = batch_typed_streams(without, 2)  # grad enabled: derived here
    assert torch.equal(st.bwd_rows, batch_typed_streams(
        with_perm, 2).bwd_rows)
    assert torch.equal(cs.derive_bwd_perm(st), with_perm.edge_bwd_perm)
    params = gm.init_gossip_model(hidden_dim=64, emb_channels=64,
                                  generator=torch.Generator().manual_seed(0))
    params = params.to(cuda_device)
    embs = torch.randn(29, 64, device=cuda_device)
    cs.reset_launches()
    gm.gossip_loss(params, without, embs).backward()
    torch.cuda.synchronize()
    got = cs.read_launches()
    assert (got["gather_segment_sum"], got["gather_segment_sum_bwd"]) == (
        1 + 4 * 29, 29)
    assert got["sorted_segment_sum"] == got["segment_sum_vjp"] == 0


def conv_batch(rng, n_graphs=6, order=3):
    """A packed target batch of small random graphs' depth-2
    neighborhoods, with random inputs, typed at ``order``."""
    from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph

    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(6, 14))
        iu = np.triu_indices(n, k=1)
        keep = rng.random(len(iu[0])) < 0.4
        graphs.append(Graph(n, np.stack([iu[0][keep], iu[1][keep]],
                                        axis=1).astype(np.int32)))
    samples, _ = Workload(graphs).neighborhood_samples(2, order=order)
    for s in samples:
        s.x = rng.standard_normal((s.n_nodes, 1)).astype(np.float32)
    return pack_samples(samples, *auto_capacities(samples, g_cap=64))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("conv,order", [("GAT", 3), ("PNA", 3), ("GIN", 3),
                                        ("GCN", 3), ("SAGE", 4)])
def test_conv_towers_on_gpu_match_cpu(rng, cuda_device, conv, order):
    """A target tower of each conv type (and order-4 typing, 33 types) on
    the card against the same on the CPU: output rtol 1e-4 of its scale,
    every parameter's gradient within 1e-4 of its scale (phase 5's
    bound). GAT runs one K1 pair per layer (num and den) and one K4 pair
    behind it, PNA two K1 sums per layer and K4 behind them, and one K4
    gather with K1 behind it (its counts are the offsets apart); both pool
    on K1 with K4 behind, never K2 or K3; the others K2 and K3."""
    import copy

    from desco_tpu_torch.models import shmp_gnn as sg

    layers = 2
    cfg = sg.neighborhood_target_config(
        order=order, hidden_dim=16, output_dim=16, layer_num=layers,
        conv_type=conv)
    params = sg.init_shmp(cfg, torch.Generator().manual_seed(1))
    batch = conv_batch(rng, order=order)
    cot = torch.randn(batch.g_cap, 16, generator=torch.Generator()
                      .manual_seed(2))
    runs = {}
    for dev, mode in (("cpu", "aggregate_first"), (cuda_device, "kernel")):
        p = copy.deepcopy(params).to(dev).requires_grad_(True)
        c = dataclasses.replace(cfg, agg_mode=mode)
        cs.reset_launches()
        out = sg.apply_shmp(p, c, batch.to(dev, training=True))
        (out * cot.to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[str(dev)] = (out.detach().cpu(),
                          {k: v.grad.cpu() for k, v in
                           p.named_parameters()}, cs.read_launches())
    (out_c, g_c, _), (out_g, g_g, n) = runs["cpu"], runs[str(cuda_device)]
    assert float((out_g - out_c).abs().max()) <= 1e-4 * float(
        out_c.abs().max())
    for k, want in g_c.items():
        scale = float(want.abs().max())
        assert float((g_g[k] - want).abs().max()) <= 1e-4 * scale, k
    # per layer: K1 sums (PNA: the sum and the squared deviations; its
    # counts are the offsets apart), K1 pairs (GAT: num and den in one
    # launch) and K4 gathers (PNA's mean, K1 behind it); K4 behind every
    # sum and pair, K1 and K4 once more for the pooling
    sums, pairs, gathers = {"GAT": (0, 1, 0), "PNA": (2, 0, 1)}.get(
        conv, (0, 0, 0))
    if sums or pairs:
        assert n["sorted_segment_sum"] == (sums + gathers) * layers + 1
        assert n["segment_sum_vjp"] == (sums + gathers) * layers + 1
        assert n["sorted_segment_sum_pair"] == pairs * layers
        assert n["segment_sum_vjp_pair"] == pairs * layers
        assert n["fused_typed_transform_aggregate"] == 0
        assert n["typed_aggregate_bwd"] == 0
    else:
        assert n["fused_typed_transform_aggregate"] == layers
        assert n["typed_aggregate_bwd"] == layers


def halo_typed_graph(rng, n=120, p=0.06):
    """(n, node_type, x, src, dst, type) of a random graph's whole-graph
    typed sample (2 edge types: triangle edges or not) with random
    inputs."""
    from desco_tpu_torch.batch.build import query_sample
    from desco_tpu_torch.graph import Graph

    iu = np.triu_indices(n, k=1)
    keep = rng.random(len(iu[0])) < p
    g = Graph(n, np.stack([iu[0][keep], iu[1][keep]], 1).astype(np.int32))
    s = query_sample(g)
    x = rng.standard_normal((n, 1)).astype(np.float32)
    return g, (n, s.node_type, x, s.edge_src, s.edge_dst, s.edge_type)


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["SAGE", "GAT", "PNA"])
def test_halo_tower_on_gpu_matches_cpu(rng, cuda_device, conv):
    """The halo SHMP core at 4 shards on the card against the same on the
    CPU, output and gradients within 1e-4 of their scale. SAGE sums its
    streams on the gather-fused K1 (forward and backward: sends, interior
    and boundary streams, 3 x 4 launches per layer on this partition),
    GAT on one K1 pair per stream and layer with one K4 pair behind, PNA
    on K1 with K4 behind; no halo sum on K2."""
    import copy

    from desco_tpu_torch.models import shmp_gnn as sg
    from desco_tpu_torch.parallel import halo

    layers = 2
    cfg = sg.neighborhood_target_config(hidden_dim=16, output_dim=16,
                                        layer_num=layers, conv_type=conv)
    params = sg.init_shmp(cfg, torch.Generator().manual_seed(3))
    _, args = halo_typed_graph(rng)
    part = halo.partition_typed_graph(*args, 4, n_types=6,
                                      force_pull=conv != "SAGE")
    cot = torch.randn(part.n_devices, part.n_loc, cfg.post_input_dim,
                      generator=torch.Generator().manual_seed(4))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = copy.deepcopy(params).to(dev).requires_grad_(True)
        shards = halo.place_shards(part, [torch.device(dev)])
        cs.reset_launches()
        outs = halo.halo_shmp_core(p, cfg, shards)
        sum((o * c.to(dev)).sum() for o, c in zip(outs, cot)).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[str(dev)] = (torch.stack([o.detach().cpu() for o in outs]),
                          {k: v.grad.cpu() for k, v in p.named_parameters()
                           if v.grad is not None}, cs.read_launches(),
                          shards)
    (out_c, g_c, _, _), (out_g, g_g, n, shards) = (runs["cpu"],
                                                   runs[str(cuda_device)])
    assert float((out_g - out_c).abs().max()) <= 1e-4 * float(
        out_c.abs().max())
    for k, want in g_c.items():
        scale = float(want.abs().max())
        assert float((g_g[k] - want).abs().max()) <= 1e-4 * scale, k
    assert all(sh.boundary is not None for sh in shards)
    sends = sum(int(sh.send.edge_src.numel() > 0) for sh in shards)
    assert n["fused_typed_transform_aggregate"] == 0
    if conv == "SAGE":
        per_agg = sends + 2 * len(shards)
        assert n["gather_segment_sum"] == layers * per_agg
        assert n["gather_segment_sum_bwd"] == layers * per_agg
        assert n["sorted_segment_sum"] == n["segment_sum_vjp"] == 0
    else:
        sums, pairs, gathers = {"GAT": (0, 1, 0), "PNA": (2, 0, 1)}[conv]
        streams = 2 * len(shards)
        assert n["sorted_segment_sum"] == layers * streams * (sums + gathers)
        assert n["segment_sum_vjp"] == layers * streams * (sums + gathers)
        assert n["sorted_segment_sum_pair"] == layers * streams * pairs
        assert n["segment_sum_vjp_pair"] == layers * streams * pairs
        assert n["gather_segment_sum"] == layers * sends


@pytest.mark.cuda
def test_halo_gossip_step_on_gpu_is_bit_stable(rng, cuda_device):
    """A halo gossip train step at 4 shards (a partition with push pairs)
    on the card: its gradients within 1e-4 of the CPU's, two same-seed
    steps (dropout 0.01) bit-equal, the gather-fused K1 forward and
    backward on every stream."""
    import copy

    from desco_tpu_torch.batch.build import gossip_sample
    from desco_tpu_torch.models import gossip as gm
    from desco_tpu_torch.parallel import halo
    from desco_tpu_torch.train.loop import make_adam

    g, _ = halo_typed_graph(rng, n=200, p=0.03)
    counts = rng.random((g.n_nodes, 3)).astype(np.float32) * 5
    truth = counts * rng.uniform(0.5, 1.5, (g.n_nodes, 1)).astype(np.float32)
    s = gossip_sample(g, counts, truth)
    part = halo.partition_typed_graph(g.n_nodes, s.node_type, counts,
                                      s.edge_src, s.edge_dst, s.edge_type,
                                      4, node_y=truth, n_types=2)
    params = gm.init_gossip_model(hidden_dim=16, emb_channels=16,
                                  generator=torch.Generator().manual_seed(5))
    embs = torch.randn(3, 16, generator=torch.Generator().manual_seed(6))
    grads = {}
    for dev in ("cpu", cuda_device):
        p = copy.deepcopy(params).to(dev).requires_grad_(True)
        halo.halo_gossip_loss(p, halo.place_shards(part, [torch.device(dev)]),
                              embs.to(dev)).backward()
        grads[str(dev)] = {k: v.grad.cpu() for k, v in p.named_parameters()
                           if v.grad is not None}
    for k, want in grads["cpu"].items():
        scale = float(want.abs().max())
        assert float((grads[str(cuda_device)][k] - want).abs().max()) <= (
            1e-4 * max(scale, 1e-30)), k
    shards = halo.place_shards(part, [cuda_device])
    steps = []
    for _ in range(2):
        p = copy.deepcopy(params).to(cuda_device)
        opt = make_adam(p)
        cs.reset_launches()
        halo.halo_gossip_step_fn(opt, dropout=0.01)(
            p, shards, embs.to(cuda_device), 1e-3, seed=7)
        torch.cuda.synchronize()
        steps.append((opt.grad.clone(), opt.flat.clone(), cs.read_launches()))
    assert torch.equal(steps[0][0], steps[1][0])
    assert torch.equal(steps[0][1], steps[1][1])
    n = steps[0][2]
    assert part.p_max > 0
    sends = sum(int(sh.send.edge_src.numel() > 0) for sh in shards)
    per_agg = sends + 4 + sum(int(sh.boundary is not None) for sh in shards)
    assert n["gather_segment_sum"] == (1 + 2 * 3) * per_agg
    assert n["gather_segment_sum_bwd"] == 3 * per_agg


@pytest.mark.cuda
@pytest.mark.parametrize("n_devices", [2, 4])
def test_dp_serving_on_gpu_equals_one_device(cuda_device, n_devices):
    """release/r4 served over 2 and 4 data-parallel replicas on the card:
    every output bit-equal to one device, K2 eight times per padded
    target batch, no backward kernel."""
    from desco_tpu_torch.data.synthetic import generate_synthetic
    from desco_tpu_torch.pipeline import prepare_stage_data
    from desco_tpu_torch.serving import CountingService

    graphs = generate_synthetic(12, min_size=10, max_size=28, seed=5)
    r4 = ("release/r4/neigh.best", "release/r4/gossip.best")
    one = CountingService(*r4, device=cuda_device)
    many = CountingService(*r4, device=cuda_device, n_devices=n_devices)
    want = one.count(graphs)
    many._neigh_buckets.update(one._neigh_buckets)
    many._gossip_buckets.update(one._gossip_buckets)
    n_b = len(prepare_stage_data(many.cfg, graphs,
                                 capacities=many._select_neigh_caps).batches)
    cs.reset_launches()
    got = many.count(graphs)
    torch.cuda.synchronize()
    n = cs.read_launches()
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    padded = -(-n_b // n_devices) * n_devices
    assert n["fused_typed_transform_aggregate"] == 8 * padded
    assert n["typed_aggregate_bwd"] == n["segment_sum_vjp"] == 0
    assert n["gather_segment_sum_bwd"] == 0


# ----------------------------------------------------------------- tools
def tool_pair(tool, argv, device, **kw):
    """One tool's ``run`` on ``device`` and on the CPU, same arguments."""
    quiet = dict(log=lambda *a: None, **kw)
    argv = [str(a) for a in argv]
    p = tool.build_parser()
    return (tool.run(p.parse_args(argv + ["--device", str(device)]),
                     **quiet),
            tool.run(p.parse_args(argv + ["--device", "cpu"]), **quiet))


def close_counts(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


def close_scale(got, want, tol=1e-4):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["raw", "service"])
def test_tool_serving_bench_on_gpu_matches_cpu(cuda_device, mode):
    from desco_tpu_torch.tools import serving_bench

    got, want = tool_pair(serving_bench, ["--graphs", 4, "--mode", mode],
                          cuda_device)
    assert got["device"] == torch.cuda.get_device_name(0)
    if mode == "raw":
        close_counts(got["graphlet_counts"], want["graphlet_counts"])
    else:
        close_counts(got["result"].node_counts, want["result"].node_counts)
        np.testing.assert_array_equal(got["result"].verified_rows,
                                      want["result"].verified_rows)


@pytest.mark.cuda
def test_tool_compute_groundtruth_on_gpu_matches_cpu(cuda_device,
                                                     tmp_path):
    from desco_tpu_torch.tools import compute_groundtruth

    got, want = tool_pair(compute_groundtruth, [
        "--dataset", "syn_6", "--query_sizes", 6, "--data_root", tmp_path],
        cuda_device)
    np.testing.assert_array_equal(got["total"], want["total"])
    assert len(got["query_ids"]) == 112


@pytest.mark.cuda
def test_tool_verify_sweep_on_gpu_matches_cpu(cuda_device, tmp_path):
    from desco_tpu_torch.tools import verify_sweep

    got, want = tool_pair(verify_sweep, [
        "--dataset", "syn_8", "--neigh_checkpoint",
        "release/r4/neigh.best", "--data_root", tmp_path], cuda_device)
    for a, b in zip(got["rows"], want["rows"]):
        assert a["rows_verified"] == b["rows_verified"]
        np.testing.assert_allclose(a["norm_mse"], b["norm_mse"], rtol=1e-3,
                                   atol=1e-12)
        close_counts(a["counts"], b["counts"])


@pytest.mark.cuda
def test_tool_scaling_on_gpu_matches_cpu(cuda_device):
    from desco_tpu_torch.tools import scaling

    cs.reset_launches()
    got, want = tool_pair(scaling, ["--nodes", 2000, "--devices", 1, 2,
                                    "--reps", 1, "--graph", "comm"],
                          cuda_device)
    assert cs.read_launches()["gather_segment_sum"] > 0
    for d in (1, 2):
        close_scale(got["out"][d], want["out"][d])
    close_scale(got["out"][2], got["out"][1])


@pytest.mark.cuda
def test_tool_large_graph_serving_on_gpu_matches_cpu(cuda_device):
    from desco_tpu_torch.tools import large_graph_serving

    got, want = tool_pair(large_graph_serving,
                          ["--nodes", 500, "--devices", 2], cuda_device)
    close_counts(got["result"].node_counts, want["result"].node_counts)
    assert got["n_loc"] == want["n_loc"]


@pytest.mark.cuda
def test_tool_runtime_on_gpu_matches_cpu(cuda_device, tmp_path):
    from desco_tpu_torch.tools import runtime

    cs.reset_launches()
    got, want = tool_pair(runtime, ["--dataset", "Syn_8", "--reps", 1,
                                    "--data_root", tmp_path], cuda_device)
    n = cs.read_launches()
    assert n["fused_typed_transform_aggregate"] > 0
    assert n["sorted_segment_sum"] > 0
    assert (got["valid_edges"], got["graphs"]) == (want["valid_edges"],
                                                   want["graphs"])
    close_scale(got["out"], want["out"])


@pytest.mark.cuda
def test_tool_complexity_analysis_on_gpu_matches_cpu(cuda_device,
                                                     tmp_path):
    from desco_tpu_torch.tools import complexity_analysis

    got, want = tool_pair(complexity_analysis, [
        "--dataset", "Syn_8", "--data_root", tmp_path], cuda_device)
    assert got == want


@pytest.mark.cuda
def test_tool_downstream_task_on_gpu_matches_cpu(cuda_device, tmp_path):
    """The labels and features are the host's truth; the MLP trains on
    each device (cuBLAS against the CPU's matmuls), so the test accuracy
    may differ by a few test nodes."""
    from desco_tpu_torch.tools import downstream_task

    got, want = tool_pair(downstream_task, [
        "--dataset", "Syn_8", "--data_root", tmp_path, "--epochs", 60],
        cuda_device)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["features"], want["features"])
    assert abs(got["acc_exact"] - want["acc_exact"]) <= 0.02


@pytest.mark.cuda
def test_tool_dataset_statistics_on_gpu_matches_cpu(cuda_device, tmp_path):
    from desco_tpu_torch.tools import dataset_statistics

    common = ["--datasets", "Syn_8", "--sample", 200, "--data_root",
              tmp_path, "--checkpoint", "release/r4/neigh.best"]
    quiet = dict(log=lambda *a: None)
    p = dataset_statistics.build_parser()
    got = dataset_statistics.run(p.parse_args([str(a) for a in common] + [
        "--out", str(tmp_path / "g"), "--device", str(cuda_device)]),
        **quiet)
    want = dataset_statistics.run(p.parse_args([str(a) for a in common] + [
        "--out", str(tmp_path / "c"), "--device", "cpu", "--projection",
        "pca"]), **quiet)
    np.testing.assert_array_equal(got["features"], want["features"])
    close_scale(got["embeddings"], want["embeddings"])
    kl = got["neighborhood_features"]["kl"]
    assert np.isfinite(kl) and kl > 0
    x = got["features"]
    close_scale(dataset_statistics.pca(x, 2, cuda_device),
                want["neighborhood_features"]["proj"], 1e-5)


def neighborhood_training_set(rng, cfg, n_graphs=24):
    """Packed target batches (with labels and permutations) of random
    graphs' neighborhoods at ``cfg``'s depth, several batches of one
    shape, with random counts of ``cfg``'s queries as labels."""
    from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph

    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(6, 14))
        iu = np.triu_indices(n, k=1)
        keep = rng.random(len(iu[0])) < 0.4
        graphs.append(Graph(n, np.stack([iu[0][keep], iu[1][keep]],
                                        axis=1).astype(np.int32)))
    samples, _ = Workload(graphs).neighborhood_samples(cfg.depth)
    n_q = len(cfg.query_ids)
    for s in samples:
        s.y = rng.uniform(0, 6, n_q).astype(np.float32)
    return pack_samples(samples, *auto_capacities(samples, g_cap=32),
                        n_queries=n_q, need_bwd_perm=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_graphed_epochs_equal_eager_on_gpu(rng, cuda_device, tmp_path,
                                           bf16):
    """Two neighborhood epochs through ``train_neighborhood``: the train
    and eval steps captured as CUDA graphs (their loops under
    ``set_sync_debug_mode("error")``) against the eager steps, the same
    weights and seed: losses, parameters and Adam's state bit for bit,
    and the same kernel launches."""
    from desco_tpu_torch.models import neighborhood as nm
    from desco_tpu_torch.pipeline import (PipelineConfig, build_query_batch,
                                          model_configs)
    from desco_tpu_torch.train import loop
    from desco_tpu_torch.train.checkpoint import flatten_params

    cfg = PipelineConfig(query_sizes=(3, 4), depth=2, neigh_layer_num=3,
                         neigh_hidden_dim=32)
    batches = neighborhood_training_set(rng, cfg)
    assert len(batches) > 2
    tt, tq = model_configs(cfg, cuda_device)
    assert tt.agg_mode == "kernel"
    train_tt = dataclasses.replace(tt, dtype=BF) if bf16 else tt
    qb = build_query_batch(cfg)
    runs = []
    for graphed in (False, True):
        params = nm.init_neighborhood_model(
            tt, tq, torch.Generator().manual_seed(0))
        path = str(tmp_path / f"run{int(graphed)}")
        cs.reset_launches()
        res = loop.train_neighborhood(
            params, train_tt, tq, qb, batches, batches[:2], epochs=2,
            lr=1e-3, ckpt_path=path, eval_tgt_cfg=tt, device=cuda_device,
            graphed=graphed, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        runs.append((res, flatten_params(res.params), cs.read_launches(),
                     np.load(path + ".last.opt.npz")))
    assert torch.cuda.get_sync_debug_mode() == 0
    (a, pa, na, oa), (b, pb, nb, ob) = runs
    assert a.train_losses == b.train_losses
    assert a.val_losses == b.val_losses
    for key, arr in pa.items():
        np.testing.assert_array_equal(arr, pb[key], err_msg=key)
    for key in oa.files:
        np.testing.assert_array_equal(oa[key], ob[key], err_msg=key)
    assert na == nb
    steps = 2 * len(batches)
    assert na["typed_aggregate_bwd"] == 3 * steps
    assert na["fused_typed_transform_aggregate"] == 3 * (steps + 2 * 2)


@pytest.mark.cuda
def test_no_sync_refuses_a_read_back_on_gpu(cuda_device):
    """The guard the graphed loops run under raises on a read-back, and
    puts the debug mode back."""
    from desco_tpu_torch.utils.cuda_graphs import no_sync

    t = torch.ones((), device=cuda_device)
    with pytest.raises(RuntimeError):
        with no_sync(cuda_device):
            t.item()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert float(t) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.01])
@pytest.mark.parametrize("d", [1, 2], ids=["one", "dp2"])
def test_graphed_gossip_epochs_equal_eager_on_gpu(rng, cuda_device, tmp_path,
                                                  dropout, d):
    """Two gossip epochs through ``train_gossip`` (one device, or a D = 2
    mesh on the one card): the train step (masks drawn ahead of each
    query's checkpointed call; with a mesh the group of two batches and
    both replicas' generators) and the eval step captured as CUDA graphs
    against the eager steps: losses, parameters and Adam's state bit for
    bit, the same launches."""
    from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
    from desco_tpu_torch.models import gossip as gm
    from desco_tpu_torch.parallel import dp
    from desco_tpu_torch.train import loop
    from desco_tpu_torch.train.checkpoint import flatten_params

    samples = gossip_samples(rng, n_graphs=12, n_queries=5)
    batches = pack_samples(samples, *auto_capacities(samples, g_cap=4),
                           n_queries=5, need_bwd_perm=True)
    assert len(batches) > 2
    embs = torch.randn(5, 16, generator=torch.Generator().manual_seed(3))
    runs = []
    for graphed in (False, True):
        params = gm.init_gossip_model(
            hidden_dim=16, emb_channels=16,
            generator=torch.Generator().manual_seed(1))
        path = str(tmp_path / f"run{int(graphed)}")
        cs.reset_launches()
        res = loop.train_gossip(
            params, embs, batches, batches[:2], epochs=2, lr=1e-3,
            dropout=dropout, ckpt_path=path, device=cuda_device,
            mesh=dp.make_mesh(2, cuda_device) if d == 2 else None,
            graphed=graphed, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        runs.append((res, flatten_params(res.params), cs.read_launches(),
                     np.load(path + ".last.opt.npz")))
    assert torch.cuda.get_sync_debug_mode() == 0
    (a, pa, na, oa), (b, pb, nb, ob) = runs
    assert a.train_losses == b.train_losses
    assert a.val_losses == b.val_losses
    for key, arr in pa.items():
        np.testing.assert_array_equal(arr, pb[key], err_msg=key)
    for key in oa.files:
        np.testing.assert_array_equal(oa[key], ob[key], err_msg=key)
    assert na == nb
    steps = 2 * (-(-len(batches) // d) * d)
    assert na["gather_segment_sum_bwd"] == 5 * steps
    assert na["gather_segment_sum"] == (1 + 4 * 5) * steps + \
        (1 + 2 * 5) * 2 * 2


@pytest.mark.cuda
def test_graphed_halo_steps_equal_eager_on_gpu(rng, cuda_device):
    """The halo gossip step (4 shards, push pairs) and the DP x halo step
    (2 x 2) captured as CUDA graphs at their first call and replayed,
    dropout 0.01, three calls each: losses, gradients, parameters and
    Adam's moments bit-equal to the eager steps', the same launches."""
    import copy

    from desco_tpu_torch.batch.build import gossip_sample
    from desco_tpu_torch.models import gossip as gm
    from desco_tpu_torch.parallel import halo, topology
    from desco_tpu_torch.train.loop import make_adam

    specs = []
    for n in (200, 160):
        g, _ = halo_typed_graph(rng, n=n, p=0.03)
        x = rng.random((n, 3)).astype(np.float32) * 5
        y = x * rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
        s = gossip_sample(g, x, y)
        specs.append(dict(n_nodes=n, node_type=s.node_type, x=x,
                          edge_src=s.edge_src, edge_dst=s.edge_dst,
                          edge_type=s.edge_type, node_y=y))
    part = halo.partition_typed_graph(n_devices=4, n_types=2, **specs[0])
    assert part.p_max > 0
    shards = halo.place_shards(part, [cuda_device])
    grid = topology.place_replicas(
        topology.stack_partitions(
            topology.harmonized_partitions(specs, 2, n_types=2)),
        topology.make_mesh2d(2, 2, devices=[cuda_device]))
    params = gm.init_gossip_model(hidden_dim=16, emb_channels=16,
                                  generator=torch.Generator().manual_seed(5))
    embs = torch.randn(3, 16, generator=torch.Generator().manual_seed(6))
    embs, lr = embs.to(cuda_device), torch.tensor(1e-3, device=cuda_device)
    # the direction degrees, kept on the shards, before either way counts
    for sh in [shards, *grid]:
        halo.halo_direction_degrees(sh)
    for make, place in ((halo.halo_gossip_step_fn, shards),
                        (topology.dp_halo_gossip_step_fn, grid)):
        runs = []
        for graphed in (False, True):
            p = copy.deepcopy(params).to(cuda_device)
            opt = make_adam(p)
            step = make(opt, 0.01, graphed=graphed)
            cs.reset_launches()
            calls = []
            for seed in (7, 8, 7):
                loss, ok = step(p, place, embs, lr, seed=seed)
                calls.append((loss, ok, opt.grad.clone(), opt.flat.clone(),
                              opt.mu.clone(), opt.nu.clone()))
            torch.cuda.synchronize()
            runs.append((calls, cs.read_launches()))
        (ca, na), (cb, nb) = runs
        for x, y in zip(ca, cb):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
        assert na == nb and na["gather_segment_sum_bwd"] > 0


class _Relay(torch.autograd.Function):
    """The identity through a split point (utils/cuda_graphs.collective),
    forward and backward: a stand-in for a cross-rank exchange."""

    @staticmethod
    def forward(ctx, x):
        from desco_tpu_torch.utils.cuda_graphs import collective
        return collective(("relay", (0,), None), x.detach(), x.shape,
                          lambda src, out: out.copy_(src))

    @staticmethod
    def backward(ctx, grad):
        from desco_tpu_torch.utils.cuda_graphs import collective
        return collective(("relay_bwd", (0,), None), grad, grad.shape,
                          lambda src, out: out.copy_(src))


@pytest.mark.cuda
def test_chained_step_captures_on_gpu(cuda_device):
    """A train step split at a relay in its forward and one in its
    backward (which autograd runs on its device thread), with dropout on
    both sides of the first split: captured as a chain of three CUDA
    graphs in one pool, every call replaying them with the relays between;
    losses and weights bit-equal to the eager step over three calls, the
    generator reseeded between them."""
    from desco_tpu_torch.utils.cuda_graphs import GraphedStep

    gen = torch.Generator(cuda_device)

    def make(w):
        def step(b):
            leaf = w.detach().requires_grad_()
            h = torch.nn.functional.dropout(torch.tanh(b[0] @ leaf), 0.2)
            mask = (torch.rand(h.shape, generator=gen, device=h.device)
                    > 0.2).float()
            y = _Relay.apply(h * mask) * (torch.rand(
                h.shape, generator=gen, device=h.device) + 0.5)
            loss = (y * y).sum()
            (grad,) = torch.autograd.grad(loss, leaf)
            w.sub_(0.1 * grad)
            return loss.detach()
        return step

    torch.manual_seed(0)
    w0 = torch.randn(64, 32, device=cuda_device)
    xs = [torch.randn(256, 64, device=cuda_device) for _ in range(3)]
    w_eager, w_chain = w0.clone(), w0.clone()
    eager = make(w_eager)
    gen.manual_seed(3)
    step = GraphedStep(make(w_chain), (xs[0],), capture=True,
                       state=[w_chain], generators=[gen])
    assert len(step.graphs) == 3 and len(step.sequence) == 2
    for i, x in enumerate(xs):
        gen.manual_seed(10 + i)
        torch.manual_seed(20 + i)
        want = eager((x,))
        gen.manual_seed(10 + i)
        torch.manual_seed(20 + i)
        got = step((x,))
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(w_chain, w_eager), i
    assert step.pool_bytes() != 0


@pytest.mark.cuda
def test_cross_rank_halo_step_chains_on_gpu(rng, cuda_device, tmp_path):
    """The 4-shard halo gossip step over two gloo ranks on the one card
    (tests/torch_dist_worker.py, scenario ``halo_card``), two calls at
    dropout 0 and 0.1, eager and graphed (a chain of CUDA graphs split at
    its exchanges and the gather): every call bit-equal on both ranks to
    the eager step over the same shards in this process; the chain has
    one graph more than split points, and no eager note is printed."""
    import os
    import pickle
    import subprocess
    import sys

    from desco_tpu_torch.batch.build import gossip_sample
    from desco_tpu_torch.models import gossip as gm
    from desco_tpu_torch.parallel import halo
    from desco_tpu_torch.train.checkpoint import (flatten_params,
                                                  params_from_jax)
    from desco_tpu_torch.train.loop import make_adam

    g, _ = halo_typed_graph(rng, n=200, p=0.03)
    x = rng.random((g.n_nodes, 3)).astype(np.float32) * 5
    y = x * rng.uniform(0.5, 1.5, (g.n_nodes, 1)).astype(np.float32)
    s = gossip_sample(g, x, y)
    part = halo.partition_typed_graph(g.n_nodes, s.node_type, x,
                                      s.edge_src, s.edge_dst, s.edge_type,
                                      4, node_y=y, n_types=2)
    params = gm.init_gossip_model(hidden_dim=16, emb_channels=16,
                                  generator=torch.Generator().manual_seed(5))
    embs = torch.randn(3, 16, generator=torch.Generator().manual_seed(6))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    job = dict(scenario="halo_card", device="cuda", halo_part=part,
               halo_gossip={k: np.asarray(v) for k, v in
                            flatten_params(params).items()},
               halo_q=embs.numpy(), world=2, timeout_s=120.0,
               init_method=f"file://{tmp_path / 'rendezvous'}",
               out_dir=str(tmp_path))
    with open(tmp_path / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_dist_worker.py"),
         str(tmp_path / "job.pkl"), str(r)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        assert "runs eager" not in err
    shards = halo.place_shards(part, [cuda_device])
    for dropout in (0.0, 0.1):
        # the ranks' parameter order: the flat layout's
        p = params_from_jax(job["halo_gossip"]).to(cuda_device)
        opt = make_adam(p)
        step = halo.halo_gossip_step_fn(opt, dropout=dropout)
        want = []
        for seed in (4, 5):
            loss, ok = step(p, shards, embs.to(cuda_device), 1e-3, seed=seed)
            want.append([float(loss), bool(ok)] + [
                t.cpu().numpy() for t in (opt.grad, opt.flat, opt.mu,
                                          opt.nu)])
        for r in range(2):
            with open(tmp_path / f"rank{r}.pkl", "rb") as f:
                res = pickle.load(f)
            for graphed in (False, True):
                got = res["step", dropout, graphed]
                for a, b in zip(got, want):
                    assert a[:2] == b[:2], (r, dropout, graphed)
                    for u, v in zip(a[2:], b[2:]):
                        np.testing.assert_array_equal(u, v)
            graphs, splits = res["chain", dropout]
            assert graphs == splits + 1 and splits == 6 * 3 + 1


# ------------------------------------------------- compiled serving forwards
@pytest.mark.cuda
def test_graphed_forwards_equal_eager_on_gpu(cuda_device):
    """release/r4's neighborhood (f32 and bf16 tower), gossip and bounds
    forwards captured as CUDA graphs: replays under ``no_sync`` (a
    read-back raises) equal the eager forwards bit for bit (these bounds'
    sums are integers below 2^24, which every order sums exactly) with
    the same launches; the service serves the same ``CountResult``
    graphed and eager, and a repeated request captures nothing."""
    from desco_tpu_torch.data.synthetic import generate_synthetic
    from desco_tpu_torch.models import gossip as gm
    from desco_tpu_torch.models import neighborhood as nm
    from desco_tpu_torch.models.shmp_gnn import prepare_batch
    from desco_tpu_torch.pipeline import (pipeline_queries,
                                          prepare_gossip_batches,
                                          prepare_stage_data)
    from desco_tpu_torch.serving import CountingService
    from desco_tpu_torch.utils import cuda_graphs as graphed
    from desco_tpu_torch.train.loop import gossip_prepare
    from desco_tpu_torch.truth.bounds import (_batch_bounds,
                                              _hashable_schedules)

    graphs = generate_synthetic(12, min_size=10, max_size=28, seed=5)
    r4 = ("release/r4/neigh.best", "release/r4/gossip.best")
    svc = CountingService(*r4, device=cuda_device)
    eager = CountingService(*r4, device=cuda_device, graphed=False)
    want = eager.count(graphs)
    got = svc.count(graphs)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    before = svc.graphs.stats()
    assert before["captures"] == before["forwards"] == 3
    svc.count(graphs)
    assert svc.graphs.stats()["captures"] == 3

    stage = prepare_stage_data(svc.cfg, graphs,
                               capacities=svc._select_neigh_caps)
    b = stage.batches[0].to(cuda_device)
    gb = prepare_gossip_batches(svc.cfg, stage, np.ones(
        (len(stage.samples), 29)))[0].to(cuda_device)
    prepare_batch(b, svc.tgt_cfg.n_edge_types, backward=False)
    gossip_prepare(gb, backward=False)
    sched = _hashable_schedules(pipeline_queries(svc.cfg))
    p, e = svc.members[0], svc.member_embs[0]
    bf16 = dataclasses.replace(svc.tgt_cfg, dtype=torch.bfloat16)
    cases = [
        (lambda x, q: nm.predict_counts_from_embs(p, svc.tgt_cfg, x, q),
         (b, e)),
        (lambda x, q: nm.predict_counts_from_embs(p, bf16, x, q), (b, e)),
        (lambda x, q: gm.gossip_predict(svc.gossip_params, x, q), (gb, e)),
        (lambda x: _batch_bounds(x, sched, 1), (b,))]
    for fn, inputs in cases:
        with torch.inference_mode():
            cs.reset_launches()
            ref = fn(*inputs)
            torch.cuda.synchronize()
            n_eager = cs.read_launches()
        fwd = graphed.GraphedStep(lambda xs, fn=fn: fn(*xs), inputs,
                                  capture=True, inference=True)
        cs.reset_launches()
        with graphed.no_sync(cuda_device):
            out = fwd(inputs)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert cs.read_launches() == n_eager


@pytest.mark.cuda
def test_graphed_halo_serve_and_bench_on_gpu(rng, cuda_device):
    """The halo serve over 4 shards on the card replays one query's
    captured forward for every query, bit-equal to the eager serve; the
    bench's forward and train step captured equal their eager runs bit
    for bit (two steps: losses, parameters, Adam's moments)."""
    import copy

    from desco_tpu_torch import bench
    from desco_tpu_torch.models import gossip as gm
    from desco_tpu_torch.models import neighborhood as nm
    from desco_tpu_torch.models.shmp_gnn import (neighborhood_target_config,
                                                 prepare_batch, query_config)
    from desco_tpu_torch.parallel import halo
    from desco_tpu_torch.train import loop

    g, _ = halo_typed_graph(rng, n=300, p=0.02)
    x = (rng.random((300, 5)) * 4).astype(np.float32)
    gp = gm.init_gossip_model(hidden_dim=16, emb_channels=16,
                              generator=torch.Generator().manual_seed(5))
    gp = gp.to(cuda_device).requires_grad_(False)
    embs = torch.randn(5, 16, generator=torch.Generator().manual_seed(6))
    embs = embs.to(cuda_device)
    outs = [halo.serve_gossip_counts(gp, g, x, embs, n_devices=4,
                                     return_stats=True, device=cuda_device,
                                     graphed=gr) for gr in (False, True)]
    assert outs[1][1]["graphed"] and not outs[0][1]["graphed"]
    np.testing.assert_array_equal(outs[1][0], outs[0][0])

    host, host_q = bench.build_workload(n_graphs=4)
    batch, qb = host.to(cuda_device, training=True), host_q.to(cuda_device)
    tt = neighborhood_target_config(layer_num=3, hidden_dim=32,
                                    output_dim=32, agg_mode="kernel")
    tq = query_config(layer_num=3, hidden_dim=32, output_dim=32)
    params = nm.init_neighborhood_model(
        tt, tq, torch.Generator().manual_seed(0)).to(cuda_device)
    for b, c in ((batch, tt), (qb, tq)):
        prepare_batch(b, c.n_edge_types, backward=True)
    fixed = copy.deepcopy(params).requires_grad_(False)

    def forward(b, q):
        return nm.predict_counts(fixed, tt, tq, b, q)

    fwds = [bench.timed_forward(forward, batch, qb, graphed=gr,
                                capture=True)() for gr in (False, True)]
    assert torch.equal(fwds[0], fwds[1])
    tb = dataclasses.replace(batch, y=torch.rand(
        batch.g_cap, 29, device=cuda_device) * 20)
    prepare_batch(tb, tt.n_edge_types, backward=True)
    runs = []
    for gr in (False, True):
        p = copy.deepcopy(params)
        opt = loop.make_adam(p)
        loss = torch.zeros((), device=cuda_device)
        loss_fn = loop.neighborhood_loss_fn(tt, tq, qb)
        gen = torch.Generator(device=cuda_device).manual_seed(1)

        def step_on(b, p=p, opt=opt, loss=loss, loss_fn=loss_fn, gen=gen):
            loss.copy_(loop.train_step(p, opt, loss_fn, b, 1e-4, gen)[0])

        step = bench.timed_step(step_on, tb, opt.state_tensors() + [loss],
                                gen, graphed=gr, capture=True)
        losses = []
        for _ in range(2):
            step()
            losses.append(loss.clone())
        torch.cuda.synchronize()
        runs.append((losses, opt.flat.clone(), opt.mu.clone()))
    assert all(torch.equal(u, v) for u, v in zip(runs[0][0], runs[1][0]))
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
