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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 33, 64, 128, 576])
def test_k1_identity_equals_probe_full_and_edge_order(rng, cuda_device, k):
    """K1 on the identity stream (graph pooling) is the probe's ``full``
    variant bit for bit, and for rows of more than 16 elements it is the
    edge-order f32 sum of each element (the order before the column
    split), so f32 rows give exactly the cumulative sum's differences."""
    from desco_tpu_torch.tools import segsum_inner_ablation as probe

    msgs, seg = sorted_stream(rng, 300, 3000, k)
    m, s = T(msgs).to(cuda_device).to(BF), T(seg).to(cuda_device)
    with torch.inference_mode():
        offs = cs.segment_offsets(s, 300)
        assert torch.equal(cs.sorted_segment_sum(m, s, 300, offs),
                           probe.probe_full(m, s, 300))
        if k > 16:  # one lane per element: edge order, bit for bit
            mf = T(msgs).to(cuda_device)
            out = cs.sorted_segment_sum(mf, s, 300, offs)
            offs = offs.cpu().numpy()
            ref = np.zeros((300, k), np.float32)
            for r in range(300):
                acc = np.zeros(k, np.float32)
                for e in range(offs[r], offs[r + 1]):
                    acc = acc + msgs[e]
                ref[r] = acc
            assert torch.equal(out.cpu(), T(ref))


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
    bound). GAT and PNA run K1 (2 and 3 sums per layer, and the pooling)
    and K4 behind them (PNA also one K4 gather per layer, K1 behind it),
    never K2 or K3; the others K2 and K3."""
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
    sums, gathers = {"GAT": (2, 0), "PNA": (3, 1)}.get(conv, (0, 0))
    if sums:
        assert n["sorted_segment_sum"] == (sums + gathers) * layers + 1
        # PNA's count of ones has no gradient
        assert n["segment_sum_vjp"] == (2 + gathers) * layers + 1
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
    GAT and PNA on K1 with K4 behind; no halo sum on K2."""
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
        sums, grad_sums, gathers = {"GAT": (2, 2, 0), "PNA": (3, 2, 1)}[conv]
        streams = 2 * len(shards)
        assert n["sorted_segment_sum"] == layers * streams * (sums + gathers)
        assert n["segment_sum_vjp"] == layers * streams * (grad_sums
                                                           + gathers)
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
