"""The gather-fused sorted segment-sum (K1 with the edge gather folded in,
``ops.cuda_segment.gather_segment_sum``) on the CPU: its plain versions,
its source-sorted backward stream and the permutation derived on the
device, against desco_tpu and against autograd.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the port against desco_tpu's XLA float32 path, forward and
``x.grad``, rtol 1e-5 with atol 1e-5 of the reference's largest value
(float32 on both sides; only the summation order differs); the backward
stream against autograd, the same; permutations and streams exactly.
The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from desco_tpu.ops import segment as jseg
from desco_tpu_torch.batch.packed import pack_samples
from desco_tpu_torch.models.shmp_gnn import batch_typed_streams
from desco_tpu_torch.ops import cuda_segment as cs
from desco_tpu_torch.ops import segment as tseg
from test_torch_cuda import gossip_samples, typed_case
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(out), ref, rtol=1e-5,
        atol=1e-5 * max(float(np.abs(ref).max(initial=0.0)), 1e-30))


def edge_case(rng, n, t, k, e, pad=64):
    """typed_case's stream (pad edges of type 63 from the zero pad node
    n - 1) with the sources restricted to the even nodes, so the odd
    ones send nothing."""
    x, src, dst, typ, keys, _ = typed_case(rng, n, t, k, 1, e, pad=pad)
    live = typ < t
    src = np.where(live, src - src % 2, src).astype(np.int32)
    return x, src, dst, typ, keys


def streams_of(src, keys, t, n, perm=None):
    return cs.typed_streams(T(src), T(keys), t, n, n,
                            None if perm is None else T(perm))


# (n, T, K, live edges): the gossip widths (layer 0, layer 1, the
# degrees), the query tower (T = 6, K = 64)
CASES = [(120, 2, 128, 700), (120, 2, 64, 700), (120, 2, 1, 700),
         (90, 6, 64, 500)]


@pytest.mark.parametrize("n,t,k,e", CASES)
def test_typed_edge_aggregate_with_streams_matches_desco_tpu(rng, n, t, k,
                                                             e):
    x, src, dst, typ, keys = edge_case(rng, n, t, k, e)
    ct = rng.standard_normal((n, t, k)).astype(np.float32)
    st = streams_of(src, keys, t, n)
    xt = T(x).requires_grad_()
    out = tseg.typed_edge_aggregate(xt, T(src), T(dst), T(typ), t,
                                    streams=st)
    (out * T(ct)).sum().backward()
    ref, vjp = jax.vjp(lambda a: jseg.typed_edge_aggregate(
        a, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(typ), t),
        jnp.asarray(x))
    close(out.detach().numpy(), ref)
    close(xt.grad.numpy(), vjp(jnp.asarray(ct))[0])
    # the odd nodes send nothing, the pad node's row stays zero
    assert float(xt.grad[1::2].abs().max()) == 0.0
    # without streams the offsets are derived from the edge arrays
    again = tseg.typed_edge_aggregate(T(x), T(src), T(dst), T(typ), t)
    assert torch.equal(again, out.detach())


@pytest.mark.parametrize("n,t,k,e", CASES)
def test_backward_stream_matches_autograd(rng, n, t, k, e):
    """dx read off the source-sorted stream (``bwd_keys`` as rows,
    ``bwd_offs[::T]`` as offsets: what the kernel walks) equals autograd
    of ``index_select`` + ``index_add_``, with the permutation
    ``pack_samples`` writes and with the one derived on the device."""
    x, src, _, _, keys = edge_case(rng, n, t, k, e)
    g = rng.standard_normal((n * t, k)).astype(np.float32)
    xt = T(x).requires_grad_()
    (cs.gather_segment_sum_plain(xt, streams_of(src, keys, t, n))
     * T(g)).sum().backward()
    perm = np.lexsort((keys % t, src, keys >= n * t)).astype(np.int32)
    for st in (streams_of(src, keys, t, n, perm),
               cs.ensure_backward_streams(streams_of(src, keys, t, n))):
        assert torch.equal(st.bwd_soffs, st.bwd_offs[::t])
        dx = cs.gather_rows_segment_sum_plain(T(g), st.bwd_keys,
                                              st.bwd_soffs, n)
        close(dx.numpy(), xt.grad.numpy())
        close(cs.gather_segment_sum_bwd(T(g), st).numpy(), xt.grad.numpy())
        close(cs.gather_segment_sum_bwd_plain(T(g), st).numpy(),
              xt.grad.numpy())
        # dead edges sort last and point at row 0
        n_live = int(st.bwd_soffs[-1])
        assert n_live == int(st.fwd_toffs[-1])
        assert bool((st.bwd_keys[n_live:] == 0).all())


@pytest.mark.parametrize("seed,n_types", [(0, 2), (1, 2), (2, 6)])
def test_derived_permutation_equals_pack_samples(seed, n_types):
    rng = np.random.default_rng(seed)
    samples = gossip_samples(rng, n_graphs=7)
    for s in samples:  # T = 6: random edge types in place of directions
        if n_types != 2:
            s.edge_type = rng.integers(0, n_types, s.n_edges).astype(
                np.int32)
    b = pack_samples(samples, 256, 2048, 8, n_queries=29)[0]
    keys = b.edge_dst * n_types + b.edge_type
    st = streams_of(b.edge_src, keys.astype(np.int32), n_types, b.n_cap)
    assert torch.equal(cs.derive_bwd_perm(st), T(b.edge_bwd_perm))
    ref = streams_of(b.edge_src, keys.astype(np.int32), n_types, b.n_cap,
                     b.edge_bwd_perm)
    cs.ensure_backward_streams(st)
    for name in ("bwd_rows", "bwd_skey", "bwd_offs", "bwd_keys",
                 "bwd_soffs"):
        assert torch.equal(getattr(st, name), getattr(ref, name)), name


def test_batch_streams_derive_the_permutation_only_under_grad():
    b = pack_samples(gossip_samples(np.random.default_rng(3)), 256, 2048, 8,
                     n_queries=29)[0]
    served = b.to("cpu")  # prediction drops the permutation
    assert served.edge_bwd_perm is None
    with torch.no_grad():
        assert batch_typed_streams(served, 2).bwd_rows is None
    st = batch_typed_streams(served, 2)
    assert st is served._typed_streams  # derived once, kept on the batch
    ref = batch_typed_streams(b.to("cpu", training=True), 2)
    assert torch.equal(st.bwd_keys, ref.bwd_keys)
    assert torch.equal(st.bwd_soffs, ref.bwd_soffs)


@pytest.mark.parametrize("k", [1, 16, 33])
def test_plain_kernel_twin_on_the_identity_stream(rng, k):
    """Without rows the kernel's plain version is K1's plain version
    (graph pooling): ids past the last offset drop."""
    msgs = rng.standard_normal((400, k)).astype(np.float32)
    seg = np.sort(rng.integers(0, 60, 400)).astype(np.int32)
    seg[-20:] = 2 ** 30
    offs = torch.searchsorted(T(seg), torch.arange(61, dtype=torch.int32),
                              out_int32=True)
    close(cs.gather_rows_segment_sum_plain(T(msgs), None, offs, 60).numpy(),
          cs.sorted_segment_sum_plain(T(msgs), T(seg), 60).numpy())


def test_gather_wrappers_take_the_plain_path_only_on_cpu(rng):
    x, src, _, _, keys = edge_case(rng, 50, 2, 8, 100)
    st = streams_of(src, keys, 2, 50)
    before = [kern.launches for kern in cs.KERNELS]
    out = cs.gather_segment_sum(T(x), st)
    cs.gather_segment_sum_bwd(torch.ones_like(out), st)
    assert [kern.launches for kern in cs.KERNELS] == before
    with pytest.raises(ValueError, match="CUDA"):
        cs.gather_segment_sum(T(x).to("meta"), st)
    with pytest.raises(ValueError, match="f32 or bf16"):
        cs.gather_segment_sum_bwd(out, st, torch.float16)
