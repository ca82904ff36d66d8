"""Static-shape packed graph batches (numpy on the host, torch on the card).

The packing is desco_tpu's (``desco_tpu/batch/packed.py``), copied so the
port imports nothing of desco_tpu, with the same layout invariants:

  * node slot ``n_cap - 1`` is reserved as the *pad node*; padded edges
    point src/dst at it, so with the model invariant ``x[pad] == 0`` they
    contribute nothing to any aggregation.
  * ``node_graph`` of padding nodes is ``g_cap`` (an extra segment that is
    sliced away after pooling).
  * edges are sorted by ``(dst, edge_type)``, so segment ids
    ``dst*T + type`` are sorted and the fused CUDA kernel
    (ops/cuda_segment.py) reads each destination's edges as one CSR row.
  * within a sample, node order preserves the original (ascending) node
    ids — canonical attribution and the gossip direction bit depend on it.

Fixed capacities matter less to an eager PyTorch forward than to XLA, but
keeping them makes the port's batches identical to desco_tpu's, so the
two sum the same edges in the same batches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..utils import trace

# Padded edges carry this sentinel type (and dst = the pad node, the
# largest slot): their combined segment id ``dst * T + type`` then sorts
# after every real edge AND falls outside ``n_types * N`` (requires
# n_types <= PAD_EDGE_TYPE), so sorted segment-sums drop them natively.
PAD_EDGE_TYPE = 63


@dataclasses.dataclass
class PackedGraphs:
    """One static-shape batch of graphs: numpy arrays on the host, torch
    tensors after ``.to(device)`` (integer fields stay int32)."""

    x: np.ndarray          # [N, F] f32 node features
    node_type: np.ndarray  # [N] i32
    node_graph: np.ndarray  # [N] i32 graph slot; pad nodes -> G
    node_mask: np.ndarray  # [N] f32 (1.0 valid)
    edge_src: np.ndarray   # [E] i32
    edge_dst: np.ndarray   # [E] i32
    edge_type: np.ndarray  # [E] i32 (gossip: direction bit 0=fwd,1=bwd)
    graph_mask: np.ndarray  # [G] f32 (1.0 valid)
    y: Optional[np.ndarray] = None       # [G, Q] graph-level labels
    node_y: Optional[np.ndarray] = None  # [N, Q] node-level labels (gossip)
    # [E] i32 permutation of the (dst,type)-sorted edge slots into
    # (src,type)-ascending order (pad edges last): the training backward
    # re-keys the edge stream by source through it. Serving packs without.
    edge_bwd_perm: Optional[np.ndarray] = None

    @property
    def n_cap(self) -> int:
        return self.x.shape[-2]

    @property
    def e_cap(self) -> int:
        return self.edge_src.shape[-1]

    @property
    def g_cap(self) -> int:
        return self.graph_mask.shape[-1]

    def fields(self):
        """(name, array) of every field that is set."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                yield f.name, v

    def to(self, device, training: bool = False) -> "PackedGraphs":
        """A copy with every field as a torch tensor on ``device``.
        Prediction drops the labels and the backward permutation, which
        the forward does not read; ``training=True`` keeps them."""
        import torch

        drop = () if training else ("y", "node_y", "edge_bwd_perm")
        host = {name: np.ascontiguousarray(v)
                for name, v in self.fields() if name not in drop}
        # the counter h2d_bytes: the host arrays copied to the device
        if trace.enabled():
            trace.add("h2d_bytes", sum(v.nbytes for v in host.values()))
        return PackedGraphs(**{name: torch.as_tensor(v).to(device)
                               for name, v in host.items()})

    def __getitem__(self, i) -> "PackedGraphs":
        """Batch ``i`` of a stacked batch (see ``stack_batches``)."""
        return PackedGraphs(**{name: v[i] for name, v in self.fields()})


@dataclasses.dataclass
class GraphSample:
    """Host-side sample: one graph with typed directed edges."""

    node_type: np.ndarray  # [k] i32
    x: np.ndarray          # [k, F] f32
    edge_src: np.ndarray   # [m] i32 (directed; both directions listed)
    edge_dst: np.ndarray   # [m] i32
    edge_type: np.ndarray  # [m] i32
    y: Optional[np.ndarray] = None       # [Q]
    node_y: Optional[np.ndarray] = None  # [k, Q]

    @property
    def n_nodes(self) -> int:
        return len(self.node_type)

    @property
    def n_edges(self) -> int:
        return len(self.edge_src)


def pack_samples(
    samples: Sequence[GraphSample],
    n_cap: int,
    e_cap: int,
    g_cap: int,
    n_queries: int = 0,
    need_bwd_perm: bool = True,
) -> List[PackedGraphs]:
    """Greedy sequential packing into fixed-capacity batches.

    All batch arrays are carved out of ONE allocation per field (views
    into a [B, cap] block), so ``stack_batches`` of a whole request is
    the block itself and one host-to-device copy moves it.
    """
    # pass 1: batch boundaries
    bounds: List[tuple] = []
    start, n_used, e_used = 0, 0, 0
    for i, s in enumerate(samples):
        if s.n_nodes > n_cap - 1 or s.n_edges > e_cap:
            raise ValueError(
                f"sample with {s.n_nodes} nodes / {s.n_edges} edges exceeds "
                f"capacities ({n_cap - 1}, {e_cap})"
            )
        if i > start and (
            n_used + s.n_nodes > n_cap - 1
            or e_used + s.n_edges > e_cap
            or i - start >= g_cap
        ):
            bounds.append((start, i))
            start, n_used, e_used = i, 0, 0
        n_used += s.n_nodes
        e_used += s.n_edges
    if start < len(samples):
        bounds.append((start, len(samples)))
    if not bounds:
        return []

    B = len(bounds)
    f_dim = samples[0].x.shape[1]
    pad_node = n_cap - 1
    has_y = samples[0].y is not None
    has_ny = samples[0].node_y is not None

    # allocate untouched, prefault all pages in parallel, then write the
    # pad values
    def alloc(shape, dtype, fill):
        a = np.empty(shape, dtype=dtype)
        allocs.append((a, fill))
        return a

    allocs: list = []
    X = alloc((B, n_cap, f_dim), np.float32, 0)
    NT = alloc((B, n_cap), np.int32, 0)
    NG = alloc((B, n_cap), np.int32, g_cap)
    NM = alloc((B, n_cap), np.float32, 0)
    ES = alloc((B, e_cap), np.int32, pad_node)
    ED = alloc((B, e_cap), np.int32, pad_node)
    ET = alloc((B, e_cap), np.int32, PAD_EDGE_TYPE)
    GM = alloc((B, g_cap), np.float32, 0)
    BWP = alloc((B, e_cap), np.int32, 0) if need_bwd_perm else None
    Y = alloc((B, g_cap, n_queries), np.float32, 0) if has_y else None
    NY = alloc((B, n_cap, n_queries), np.float32, 0) if has_ny else None

    from ..utils.memory import prefault

    prefault(*[a for a, _ in allocs])
    for a, fill in allocs:
        a.fill(fill)

    for bi, (lo, hi) in enumerate(bounds):
        off = 0
        srcs, dsts, types = [], [], []
        for gi in range(hi - lo):
            s = samples[lo + gi]
            k = s.n_nodes
            X[bi, off:off + k] = s.x
            NT[bi, off:off + k] = s.node_type
            NG[bi, off:off + k] = gi
            NM[bi, off:off + k] = 1.0
            GM[bi, gi] = 1.0
            if has_y:
                Y[bi, gi] = s.y
            if has_ny:
                NY[bi, off:off + k] = s.node_y
            srcs.append(s.edge_src + off)
            dsts.append(s.edge_dst + off)
            types.append(s.edge_type)
            off += k
        if srcs:
            es = np.concatenate(srcs).astype(np.int32)
            ed = np.concatenate(dsts).astype(np.int32)
            et = np.concatenate(types).astype(np.int32)
            # sort by (dst, type): segment ids dst*T+type are sorted and
            # each destination's edges form one contiguous CSR row
            order = np.lexsort((et, ed))
            m = len(es)
            ES[bi, :m] = es[order]
            ED[bi, :m] = ed[order]
            ET[bi, :m] = et[order]
        # backward companion: slot permutation sorting edges by
        # (src, type); pad slots (src = pad node, the max id) sort last
        if need_bwd_perm:
            BWP[bi] = np.lexsort((ET[bi], ES[bi])).astype(np.int32)

    return [
        PackedGraphs(
            x=X[bi], node_type=NT[bi], node_graph=NG[bi], node_mask=NM[bi],
            edge_src=ES[bi], edge_dst=ED[bi], edge_type=ET[bi],
            graph_mask=GM[bi],
            y=Y[bi] if has_y else None,
            node_y=NY[bi] if has_ny else None,
            edge_bwd_perm=BWP[bi] if need_bwd_perm else None,
        )
        for bi in range(B)
    ]


def auto_capacities(
    samples: Sequence[GraphSample], g_cap: int, slack: float = 1.0,
) -> tuple[int, int, int]:
    """Pick (n_cap, e_cap, g_cap) so that g_cap-sized batches of these
    samples fit — desco_tpu's rounding exactly (nodes to 128, edges to
    512), so both packages cut a request into the same batches.
    ``slack`` > 1 leaves headroom for later, slightly larger requests
    (the serving buckets pass 1.2)."""
    if not samples:
        raise ValueError(
            "auto_capacities needs at least one sample; callers with "
            "possibly-empty requests must short-circuit (serving does)")
    nodes = np.array([s.n_nodes for s in samples], dtype=np.int64)
    edges = np.array([s.n_edges for s in samples], dtype=np.int64)
    g_cap = min(g_cap, len(samples))
    mean_n = float(nodes.mean()) if len(nodes) else 1.0
    mean_e = float(edges.mean()) if len(edges) else 1.0
    n_cap = int(max(nodes.max() + 1, slack * g_cap * mean_n + 1))
    e_cap = int(max(edges.max(), slack * g_cap * mean_e))
    r128 = lambda v: ((v + 127) // 128) * 128  # noqa: E731
    r512 = lambda v: ((v + 511) // 512) * 512  # noqa: E731
    return r128(n_cap + 1), r512(max(e_cap, 1)), g_cap


def stack_batches(batches: List[PackedGraphs]) -> PackedGraphs:
    """Stack same-shape batches along a new leading axis.

    When the batches are consecutive views into one block (as produced by
    ``pack_samples``), the block is returned directly instead of copied.
    """

    def stack(xs):
        base = xs[0].base
        if (
            isinstance(base, np.ndarray)  # not an unpickled array's buffer
            and base.ndim == xs[0].ndim + 1
            and all(x.base is base for x in xs)
        ):
            # locate xs[0]'s row in the block so mid-block slices stay
            # zero-copy too
            for j in range(base.shape[0] - len(xs) + 1):
                if np.shares_memory(xs[0], base[j]):
                    break
            else:
                return np.stack(xs)
            if all(np.shares_memory(x, base[j + i])
                   for i, x in enumerate(xs)):
                return base[j:j + len(xs)]
        return np.stack(xs)

    names = [name for name, _ in batches[0].fields()]
    return PackedGraphs(**{
        name: stack([getattr(b, name) for b in batches]) for name in names})
