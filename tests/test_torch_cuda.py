"""desco_tpu_torch CUDA kernels against their plain PyTorch versions, on
the GPU (``cuda`` marker; they skip without one — a CUDA kernel has no
CPU mode). This file imports no JAX and needs nothing from
tests/conftest.py (which imports JAX), so it runs on a GPU machine
without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance rtol 1e-5, atol 1e-5 * max|ref|: float32 on both sides, only
the summation order differs (the plain version's index_add_ uses
atomics). Gradients through the kernels (K3 behind K2, K4 behind K1) are
held against autograd of the plain forward, f32 against f32, at rtol 1e-4
of each tensor's scale: two reductions and two matmuls deep."""

import numpy as np
import pytest
import torch

from desco_tpu_torch.ops import cuda_segment as cs

T = torch.from_numpy


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
        out = cs.sorted_segment_sum(m, s, 700)
        ref = cs.sorted_segment_sum_plain(m, s, 700)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("t,k", [(6, 64), (2, 128), (3, 33)])
def test_k2_kernel_matches_plain_on_gpu(rng, cuda_device, t, k):
    n = 1000
    x, src, _, _, keys, w = typed_case(rng, n, t, 64, k, 6000)
    args = [T(a).to(cuda_device) for a in (x, src, keys, w)]
    with torch.inference_mode():
        out = cs.fused_typed_transform_aggregate(*args[:3], args[3], t, n)
        ref = cs.fused_typed_transform_aggregate_plain(
            *args[:3], args[3], t, n)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


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
@pytest.mark.parametrize("t,k", [(6, 64), (2, 128), (3, 33)])
def test_k3_kernel_matches_plain_on_gpu(rng, cuda_device, t, k):
    n = 1000
    x, src, _, _, keys, w = typed_case(rng, n, t, 64, k, 6000)
    perm = bwd_perm_of(src, keys, t, n)
    st = cs.typed_streams(T(src).to(cuda_device), T(keys).to(cuda_device),
                          t, n, n, T(perm).to(cuda_device))
    g = T(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    before = cs.typed_cotangent_sums.launches
    u = cs.typed_cotangent_sums(g, st)
    torch.cuda.synchronize()
    assert cs.typed_cotangent_sums.launches == before + 1
    ref = cs.typed_cotangent_sums_plain(g, st)
    torch.testing.assert_close(u, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


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
        before = cs.typed_cotangent_sums.launches
        (fn(xs, sd, kd, ws, t, n, **kw) ** 2).sum().backward()
        if kw:
            assert cs.typed_cotangent_sums.launches == before + 1
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
    (cs.sorted_segment_sum(m, s, 50) * wgt).sum().backward()
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
        cs.sorted_segment_sum(m, s, 50)
        assert cs.sorted_segment_sum.launches == before + 1
        with pytest.raises(ValueError, match="int32"):
            cs.sorted_segment_sum(m, s.long(), 50)
        with pytest.raises(ValueError, match="contiguous"):
            cs.sorted_segment_sum(m.t().contiguous().t(), s, 50)
        with pytest.raises(ValueError, match="CUDA"):
            cs.sorted_segment_sum(m, T(seg), 50)
