"""The host-side pieces of the tiled typed-aggregate kernels (K2 and K3 of
desco_tpu_torch, ``csrc/typed_aggregate.cu``), on the CPU: the
per-(row, type) offsets of ``TypedStreams``, the tile plan, the zero
padding of odd widths, the split-TF32 arithmetic the kernels run on the
tensor cores (emulated here), and K3's fixed-order sum of per-block dW
partials. The plain versions are held against desco_tpu's
``fused_typed_transform_aggregate`` with ``bwd_perm``, its Pallas kernel
in interpret mode.

Tolerances: the f32 kernels are held to rtol 1e-5 with atol 1e-5 of the
largest |value| on the card (chip_smoke.py's ``max_err``), and the
split-TF32 emulation must stay inside that here; against the Pallas path,
which rounds z and the cotangents to bf16, error / tensor scale < 2e-2
(tests/test_torch_grad.py's bound)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import desco_tpu.ops.pallas_segment as ps
from desco_tpu_torch.ops import cuda_segment as cs

from test_torch_cuda import bwd_perm_of, typed_case
from test_torch_segment import interpret_mode  # noqa: F401 (fixture)
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy
KERNEL_RTOL = 1e-5  # chip_smoke.py's max_err: rtol and atol / max|ref|


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def streams(rng, n, t, h=8, k=8, e=900, hole=None):
    """A stream of ``typed_case`` and its streams on the CPU; ``hole``
    moves live destinations and sources out of rows [lo, hi)."""
    x, src, dst, typ, keys, w = typed_case(rng, n, t, h, k, e)
    if hole:
        lo, hi = hole
        live = typ < t
        dst = np.where(live & (dst >= lo) & (dst < hi), dst + hi - lo, dst)
        src = np.where(live & (src >= lo) & (src < hi), src + hi - lo, src)
        keys = np.where(live, dst * t + typ, keys)
        order = np.argsort(keys, kind="stable")
        src, keys = src[order], keys[order]
    src, keys = src.astype(np.int32), keys.astype(np.int32)
    st = cs.typed_streams(T(src), T(keys), t, n, n,
                          T(bwd_perm_of(src, keys, t, n)))
    return x, src, keys, w, st


SHAPES = [(300, 6), (129, 6), (1000, 2), (333, 3), (64, 6)]


@pytest.mark.parametrize("n,t", SHAPES)
def test_fwd_type_offsets_match_numpy(rng, n, t):
    _, src, keys, _, st = streams(rng, n, t)
    offs = st.fwd_toffs.numpy()
    assert st.fwd_toffs.dtype == torch.int32 and offs.shape == (n * t + 1,)
    np.testing.assert_array_equal(
        offs, np.searchsorted(keys, np.arange(n * t + 1), side="left"))
    for run in range(n * t):  # run d*T + t holds exactly the key d*T + t
        assert (keys[offs[run]:offs[run + 1]] == run).all()
    assert offs[-1] == int((keys < n * t).sum())


@pytest.mark.parametrize("n,t", SHAPES)
def test_bwd_type_offsets_match_numpy(rng, n, t):
    _, src, keys, _, st = streams(rng, n, t)
    live = keys < n * t
    skey = np.sort((src * t + keys % t)[live])
    np.testing.assert_array_equal(
        st.bwd_offs.numpy(),
        np.searchsorted(skey, np.arange(n * t + 1), side="left"))


@pytest.mark.parametrize(
    "n,t,hole", [(n, t, None) for n, t in SHAPES]
    + [(300, 6, (32, 96)), (1000, 2, (32, 96)), (333, 3, (32, 96))])
def test_tile_plan_covers_each_live_edge_once(rng, n, t, hole):
    _, src, keys, _, st = streams(rng, n, t, hole=hole)
    n_live = int((keys < n * t).sum())
    for offs in (st.fwd_toffs, st.bwd_offs):
        tiles = cs.tile_edge_ranges(offs, n, t).numpy()
        assert tiles.shape == (-(-n // cs.TILE_ROWS), 2)
        covered = np.concatenate([np.arange(lo, hi) for lo, hi in tiles])
        np.testing.assert_array_equal(covered, np.arange(n_live))
    fwd = cs.tile_edge_ranges(st.fwd_toffs, n, t).numpy()
    for i, (lo, hi) in enumerate(fwd):  # a tile's edges end in its rows
        dst = keys[lo:hi] // t
        assert ((dst >= i * cs.TILE_ROWS)
                & (dst < (i + 1) * cs.TILE_ROWS)).all()
    assert (keys[fwd[-1, 1]:] >= n * t).all()  # padding is never walked
    if hole:
        for offs in (st.fwd_toffs, st.bwd_offs):
            tiles = cs.tile_edge_ranges(offs, n, t).numpy()
            assert (tiles[1:3, 0] == tiles[1:3, 1]).all()


@pytest.mark.parametrize("h,k", [(13, 33), (16, 33), (64, 64), (5, 128)])
def test_zero_padding_leaves_the_plain_results_unchanged(rng, h, k):
    n, t = 200, 3
    x, src, keys, w, st = streams(rng, n, t, h, k)
    xt, wt = T(x), T(w)
    xp, wp = cs.pad_operands(xt, wt)
    assert xp.shape == (n, -(-h // 8) * 8)
    assert wp.shape == (t, -(-h // 8) * 8, -(-k // 8) * 8)
    if (h, k) == (64, 64):
        assert xp is xt and wp is wt  # the paper width copies nothing
    ref = cs.fused_typed_transform_aggregate_plain(xt, T(src), T(keys), wt,
                                                   t, n)
    pad = cs.fused_typed_transform_aggregate_plain(xp, T(src), T(keys), wp,
                                                   t, n)
    torch.testing.assert_close(pad[:, :k], ref, rtol=1e-6, atol=1e-6)
    assert bool((pad[:, k:] == 0).all())
    g = T(rng.standard_normal((n, k)).astype(np.float32))
    gp = torch.cat([g, g.new_zeros((n, wp.shape[2] - k))], dim=1)
    dx, dw = cs.typed_aggregate_bwd_plain(g, xt, wt, st)
    dxp, dwp = cs.typed_aggregate_bwd_plain(gp, xp, wp, st)
    torch.testing.assert_close(dxp[:, :h], dx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dwp[:, :h, :k], dw, rtol=1e-6, atol=1e-6)
    assert bool((dwp[:, h:] == 0).all())


# ---------------------------------------------- split TF32, emulated
def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """f32 cut to TF32 (10 stored mantissa bits) by clearing the 13 low
    mantissa bits: the kernels' split of a value into hi, and what the
    tensor core reads of any f32 bit pattern it is given."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a, b, a_exact=False, b_exact=False, passes=3):
    """a @ b as the kernels run it: each operand split into hi =
    tf32_trunc(v) and lo = v - hi, which the tensor core reads cut to TF32
    in turn (an operand that came from bf16 is exact and not split); the
    small cross terms first, then hi @ hi, each product of TF32 values
    exact and each pass's sum rounded to f32. ``passes=1`` is plain
    TF32."""
    a_hi, b_hi = tf32_trunc(a), tf32_trunc(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    d = torch.float64
    out = torch.zeros(a.shape[0], b.shape[1])
    if passes > 1:
        if not a_exact:
            out += (a_lo.to(d) @ b_hi.to(d)).float()
        if not b_exact:
            out += (a_hi.to(d) @ b_lo.to(d)).float()
    return out + (a_hi.to(d) @ b_hi.to(d)).float()


def within_kernel_tolerance(out, ref) -> bool:
    err = (out.double() - ref).abs()
    return bool((err <= KERNEL_RTOL * ref.abs().max()
                 + KERNEL_RTOL * ref.abs()).all())


def paper_width_operands(rng, n=512, t=6, h=64, k=64, deg=9):
    """A [n, T*H] as K2 builds it (sums of ~deg/T rows of N(0, 1) x per
    (dst, type) run) and W [T*H, K] at desco_tpu's init scale."""
    runs = rng.poisson(deg / t, (n, t, 1))
    a = rng.standard_normal((n, t, h)) * np.sqrt(np.maximum(runs, 0))
    w = rng.standard_normal((t * h, k)) / np.sqrt(h)
    return (T(a.reshape(n, t * h).astype(np.float32)),
            T(w.astype(np.float32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_holds_the_f32_tolerance_at_paper_width(seed):
    a, w = paper_width_operands(np.random.default_rng(seed))
    ref = a.double() @ w.double()
    assert within_kernel_tolerance(split_tf32_matmul(a, w), ref)
    # plain TF32 does not: that is why the kernels split
    assert not within_kernel_tolerance(split_tf32_matmul(a, w, passes=1),
                                       ref)


def test_two_pass_split_is_exact_enough_for_bf16_operands():
    a, w = paper_width_operands(np.random.default_rng(2))
    wb = w.to(torch.bfloat16).float()  # a bf16 W: exact in TF32
    assert torch.equal(tf32_trunc(wb), wb)
    ref = a.double() @ wb.double()
    assert within_kernel_tolerance(
        split_tf32_matmul(a, wb, b_exact=True), ref)


def test_tf32_split_carries_a_value_to_2_pow_minus_21():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -10 + 2.0 ** -11),
                      3.0, 1.0 + 2.0 ** -12])
    want = torch.tensor([1.0, -(1.0 + 2.0 ** -10), 3.0, 1.0])
    assert torch.equal(tf32_trunc(x), want)  # cut toward zero
    r = torch.randn(100000)
    hi = tf32_trunc(r)
    assert torch.equal(tf32_trunc(hi), hi)
    # randn draws an exact 0 in about 1% of calls: it must stay 0, and
    # the relative errors are taken over the other values
    zero = r == 0
    assert not hi[zero].any()
    scale = torch.where(zero, torch.ones_like(r), r.abs())
    assert float(((r - hi).abs() / scale).max()) < 2.0 ** -10
    lo = tf32_trunc(r - hi)
    assert float(((r - hi - lo).abs() / scale).max()) <= 2.0 ** -21


# ------------------------------------------------- dW across blocks
def dw_by_blocks(x, u, n_blocks: int) -> torch.Tensor:
    """K3's dW: block b owns the tiles b, b + n_blocks, ... of TILE_ROWS
    source rows and sums x_tile^T @ U_tile into its f32 partial; the
    reduction sums the partials in block order, in eight contiguous
    ranges of blocks combined in range order (dw_reduce_kernel)."""
    n, t, k = u.shape
    rows = cs.TILE_ROWS
    partial = torch.zeros(n_blocks, t, x.shape[1], k)
    for tile in range(-(-n // rows)):
        sl = slice(tile * rows, min((tile + 1) * rows, n))
        partial[tile % n_blocks] += torch.einsum("nh,ntk->thk", x[sl], u[sl])
    per = -(-n_blocks // 8)
    ranges = [partial[w * per:(w + 1) * per].sum(0) if w * per < n_blocks
              else torch.zeros_like(partial[0]) for w in range(8)]
    out = torch.zeros_like(partial[0])
    for r in ranges:
        out = out + r
    return out


@pytest.mark.parametrize("n_blocks", [1, 5, 132])
def test_fixed_order_dw_reduction_equals_the_einsum(rng, n_blocks):
    n, t, h, k = 1000, 6, 16, 24
    x, src, keys, w, st = streams(rng, n, t, h, k, e=6000)
    g = T(rng.standard_normal((n, k)).astype(np.float32))
    u = cs.typed_cotangent_sums_plain(g, st).view(n, t, k)
    _, dw = cs.typed_aggregate_bwd_plain(g, T(x), T(w), st)
    got = dw_by_blocks(T(x), u, n_blocks)
    torch.testing.assert_close(got, dw, rtol=KERNEL_RTOL,
                               atol=KERNEL_RTOL * float(dw.abs().max()))
    assert torch.equal(got, dw_by_blocks(T(x), u, n_blocks))  # fixed order


# --------------------------------- the plain versions against desco_tpu
@pytest.mark.parametrize("t,h,k", [(2, 64, 64), (6, 16, 33)])
def test_plain_k2_k3_match_pallas_interpret_with_bwd_perm(
        rng, interpret_mode, t, h, k):
    """The aggregate-first plain forward and K3's plain backward against
    desco_tpu's ``_fused_perm`` (transform first, z and the cotangents
    rounded to bf16 in its Pallas kernel, run in interpret mode)."""
    n = 128
    x, src, keys, w, st = streams(rng, n, t, h, k, e=400)
    perm = bwd_perm_of(src, keys, t, n)
    g = rng.standard_normal((n, k)).astype(np.float32)

    def f(x_, w_):
        out = ps.fused_typed_transform_aggregate(
            x_, jnp.asarray(src), jnp.asarray(keys), w_, t, n,
            bwd_perm=jnp.asarray(perm))
        return (out * jnp.asarray(g)).sum(), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    xs, ws = T(x).clone().requires_grad_(), T(w).clone().requires_grad_()
    out = cs.fused_typed_transform_aggregate(xs, T(src), T(keys), ws, t, n,
                                             bwd_perm=T(perm))
    (out * T(g)).sum().backward()
    for got, want in ((out.detach().numpy(), ref_out), (xs.grad.numpy(),
                      ref_grads[0]), (ws.grad.numpy(), ref_grads[1])):
        want = np.asarray(want, np.float32)
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 2e-2, rel


def test_parts_probe_finds_every_guard_it_switches_off():
    """tools/typed_aggregate_parts.py rebuilds K2 and K3 with parts
    switched off by editing guards of the committed source: each guard
    must still be there, once."""
    from desco_tpu_torch.tools import typed_aggregate_parts as parts

    sources = parts.variant_sources()
    assert set(sources) == {"full", "no_gather", "no_products", "neither"}
    with open(cs.TYPED_SOURCE) as f:
        assert sources["full"] == f.read()
    assert len(set(sources.values())) == 4
    assert sources["neither"].count("if (false)") == 5
