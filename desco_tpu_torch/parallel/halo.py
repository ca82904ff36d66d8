"""Edge-partitioned graph parallelism with a hybrid pull/push halo
exchange — the port of ``desco_tpu/parallel/halo.py``.

ONE large typed graph is cut into D shards (contiguous node ranges with
degree-aware cut points). Per ordered (src-owner, dst-owner) pair the
host partitioner picks the cheaper of two static plans: PULL (the dst
owner keeps the edges and fetches the unique remote source rows) or PUSH
(the src owner keeps them, sums partial aggregates per remote (dst, type)
cell and ships the partials). Each shard's resident edges are split into
two (dst, type)-sorted streams: INTERIOR (locally owned sources: intra
edges and every push edge; keys span [local cells | outgoing push
slots]) and BOUNDARY (pull-mode cross edges; sources index the received
halo table). The host partitioner (``HaloPartition``,
``partition_typed_graph``, ``locality_order``) is desco_tpu's numpy code,
copied so the port imports nothing of desco_tpu; the same inputs give
array-equal partitions.

Shards as a list. desco_tpu runs the per-shard code inside
``shard_map`` with ``all_to_all`` and ``psum`` on a ``graph`` axis. Here
a process holds its shards as a list (``place_shards``) of the global
length D: shard d's tensors live on ``devices[d % len(devices)]``, and
each step loops over the shards it holds in desco_tpu's step order.
``all_to_all`` is, per (sender, receiver) pair, the sender's block copied
with ``.to(receiver device)`` (a no-op where both share a device;
autograd passes through it), and ``psum`` a sum over the shards in shard
order. More shards than devices stand in for the fake host devices
desco_tpu's tests use (D = 4 on the CPU or on one card); ``n_devices``
keeps desco_tpu's meaning, the number of shards, 0 for every visible
CUDA device.

desco_tpu's ``graph`` axis may span processes (a mesh over every
process's devices, or ``make_mesh2d``'s plain fallback grid,
parallel/topology.py). Here that is a shard list placed with ``ranks``:
slot d is None where another rank of the ``torch.distributed`` group
holds it, and every list of per-shard tensors below has one entry per
shard this process holds, in slot order. The blocks between ranks go
through ``utils/distributed.exchange_blocks``, one collective per
exchange site for all of a rank's shards, in the process group of the
ranks the list spans; ``psum`` gathers every slot's value and adds them
in slot order on every rank. Every rank issues the same collectives in
the same order, forward and backward (each exchange is one autograd node
on every rank, created at the same point of the same code). A CUDA graph
cannot hold a collective, so a compiled step whose shards span ranks is
a chain of graphs split at its exchanges and its gather
(``halo_gossip_step_fn``, utils/cuda_graphs.GraphedStep).

Gradients: where autograd is on, each shard slot reads views of its
own of the parameters (``shard_params``), made in reverse slot order, so
a backward to the master parameters adds the slots' terms in slot order;
a train step gives each slot leaves of its own that share the
parameters' storage and takes each slot's gradient alone (one row per
slot, ``slot_terms``, gathered across ranks and summed in slot order):
one process and the ranks add the same numbers in the same order.

The halo sums run on the port's kernels (ops/cuda_segment.py). The
interior and boundary streams of the SAGE-family aggregation and the
gossip are one-type ``TypedStreams`` over n_loc*T + D*p_max and n_loc*T
segments, derived once per shard: the gather-fused K1 sums them in one
launch each, without an [E, H] message tensor, and its backward is the
same kernel over the source-sorted stream (no atomics). The pull's send
gather is the same kernel over the live send slots, so the backward of
a row sent to several peers sums its cotangents without atomics too.
GAT's and PNA's sums go through K1 with the shard's offsets (GAT's
numerator and denominator in one launch per stream,
``sorted_segment_sum_pair``; K4 behind them), PNA's counts are the
streams' offsets apart (``segment_counts``) and PNA's mean goes back to
the edges through K4 (``sorted_gather``), as the packed towers do;
segment max / min through ``ops.segment.segment_max``. CPU tensors take
the plain versions. The received push partials are written one peer at
a time, in peer order (a gather, an add and an ``index_copy`` into the shard's
cells): within one peer the targets are unique, and the dead slots
(desco_tpu points them out of range and ``.at[].add`` drops them) are
sent to spill rows past the cells, one per slot, that are cut off. So no
halo sum adds atomically. The one atomic add left is the backward of
that gather (``index_select``'s is an ``index_add_``), and its rows are
distinct within a peer, so no two adds meet: a halo train step gives the
same bits every run.

Every step of ``halo_typed_aggregate`` runs inside a
``torch.profiler.record_function`` range (``halo_pull_L{k}``,
``halo_interior_L{k}``, ``halo_push_L{k}``, ``halo_boundary_L{k}``): a
profiler trace shows the steps, and ``parallel/overlap_check.py`` reads
the same ranges to tag the ops. On one device the steps run in order on
one CUDA stream: the freedom to overlap the exchanges with the local sums
is structural here (no interior op reads a pull result), not measured.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.shmp_gnn import (
    SHMPConfig,
    _apply_post,
    _per_type_linear,
    cast_params,
    dropout as _dropout,
    map_params,
    gat_softmax_out,
    pna_log_degree_sum,
    pna_mix,
    run_shmp_layers_sharded,
    segment_pick,
)
from ..ops.cuda_segment import (
    TypedStreams,
    gather_segment_sum,
    segment_counts,
    sorted_gather,
    sorted_segment_sum,
    sorted_segment_sum_pair,
    typed_streams,
)
from ..ops.segment import graph_pool_sum, segment_max
from ..utils import distributed
from ..utils.cuda_graphs import GraphedStep, clone_outputs, placed_step_fn


# ------------------------------------------------ host partitioner (numpy)
@dataclasses.dataclass
class HaloPartition:
    """Device-sharded typed graph (leading axis = shard), desco_tpu's
    ``HaloPartition`` as plain numpy arrays."""

    # per-shard node data
    x: np.ndarray            # [D, n_loc, F]
    node_type: np.ndarray    # [D, n_loc]
    node_mask: np.ndarray    # [D, n_loc]
    node_graph: np.ndarray   # [D, n_loc] graph slot (for pooling)
    # per-shard resident edges, split into two sorted streams (module
    # docstring): interior srcs index the LOCAL node table, boundary srcs
    # index the received HALO table
    edge_src_int: np.ndarray  # [D, e_int] index < n_loc
    edge_seg_int: np.ndarray  # [D, e_int] key < n_loc*T + D*p_max (pad: ==)
    edge_src_bnd: np.ndarray  # [D, e_bnd] index < D*h_max
    edge_seg_bnd: np.ndarray  # [D, e_bnd] key < n_loc*T (pad: ==)
    # pull plan: boundary rows this shard sends to each peer
    send_idx: np.ndarray     # [D, D, h_max] local ids this shard sends
    send_mask: np.ndarray    # [D, D, h_max]
    # push plan: local (dst,type) cell ids of partials received from each
    # peer; dead slots point out of range
    push_tgt: np.ndarray     # [D, D, p_max] i32 cell ids < n_loc*T
    node_y: Optional[np.ndarray] = None  # [D, n_loc, Q] per-node labels
    # global-node-id range owned by each shard: [node_range[d, 0],
    # node_range[d, 1])
    node_range: Optional[np.ndarray] = None  # [D, 2] i64
    n_graphs: int = 1
    # number of edge types baked into the segment keys
    n_types: int = 1

    @property
    def n_devices(self) -> int:
        return self.x.shape[0]

    @property
    def n_loc(self) -> int:
        return self.x.shape[1]

    @property
    def h_max(self) -> int:
        return self.send_idx.shape[-1]

    @property
    def p_max(self) -> int:
        return self.push_tgt.shape[-1]


def partition_caps(part: HaloPartition) -> dict:
    """The padded capacities of a partition — pass the element-wise max
    over several partitions back as ``min_caps`` to harmonize shapes."""
    return {"n_loc": part.n_loc,
            "e_int": part.edge_src_int.shape[-1],
            "e_bnd": part.edge_src_bnd.shape[-1],
            "h_max": part.h_max, "p_max": part.p_max}


def unpartition_nodes(part: HaloPartition, arr: np.ndarray) -> np.ndarray:
    """[D, n_loc, ...] per-shard node values -> [n_nodes, ...] in global
    node order (inverse of the partitioner's range layout)."""
    r = np.asarray(part.node_range)
    arr = np.asarray(arr)
    return np.concatenate([
        arr[dev, :int(r[dev, 1] - r[dev, 0])]
        for dev in range(part.n_devices)
    ], axis=0)


def partition_node_values(part: HaloPartition,
                          vals: np.ndarray) -> np.ndarray:
    """[n_nodes, ...] global node values -> [D, n_loc, ...] shards padded
    with zeros (the partitioner's range layout)."""
    r = np.asarray(part.node_range)
    d, n_loc = part.n_devices, part.n_loc
    out = np.zeros((d, n_loc) + vals.shape[1:], vals.dtype)
    for dev in range(d):
        lo, hi = int(r[dev, 0]), int(r[dev, 1])
        out[dev, :hi - lo] = vals[lo:hi]
    return out


def locality_order(n_nodes: int, edge_src: np.ndarray,
                   edge_dst: np.ndarray, method: str = "metis",
                   coarse_target: int = 128, seed: int = 0) -> np.ndarray:
    """Locality-aware node ordering for the contiguous-range partitioner.
    Returns ``order`` (position -> original node id).

      * ``metis`` — multilevel heavy-edge-matching coarsening down to
        ~``coarse_target`` supernodes (random visit order from
        ``default_rng(seed)``), then a greedy linear arrangement of the
        supernodes by edge density, so strongly coupled clusters land
        adjacent in id space;
      * ``bfs`` — BFS visit order, restarted per component.

    On expanders (ER/BA) any balanced cut is Omega(E) and no ordering
    helps.

    Usage:
        order = locality_order(n, src, dst)
        inv = np.empty_like(order); inv[order] = np.arange(n)
        part = partition_typed_graph(n, node_type[order], x[order],
                                     inv[src], inv[dst], edge_type, D, ...)
        # unpartition_nodes(part, out)[inv] restores original node order
    """
    if method != "metis":
        return _bfs_order(n_nodes, edge_src, edge_dst)

    rng = np.random.default_rng(seed)
    u = np.concatenate([edge_src, edge_dst]).astype(np.int64)
    v = np.concatenate([edge_dst, edge_src]).astype(np.int64)
    w = np.ones(len(u), np.int64)
    cmap_total = np.arange(n_nodes, dtype=np.int64)
    n_cur = n_nodes
    while n_cur > coarse_target:
        # heavy-edge matching in random visit order
        o = np.argsort(u, kind="stable")
        uu, vv, ww = u[o], v[o], w[o]
        deg = np.bincount(uu, minlength=n_cur)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        match = np.full(n_cur, -1, np.int64)
        joined = []
        for a in rng.permutation(n_cur):
            if match[a] >= 0:
                continue
            s, e = indptr[a], indptr[a + 1]
            nb, nw = vv[s:e], ww[s:e]
            ok = (nb != a) & (match[nb] < 0)
            if ok.any():
                b = nb[ok][np.argmax(nw[ok])]
                match[a] = b
                match[b] = a
            else:
                match[a] = a
                ok2 = nb != a
                if ok2.any():
                    joined.append((a, nb[ok2][np.argmax(nw[ok2])]))
        rep = np.minimum(np.arange(n_cur), match)
        # hub/leaf regime: when pair matching stalls (merges <10% of the
        # nodes — a star merges ONE pair per round), blocked nodes join
        # their heaviest matched neighbor's pair instead
        n_pairs = int((match != np.arange(n_cur)).sum()) // 2
        if n_pairs * 10 < n_cur:
            for a, b in joined:
                rep[a] = rep[b]
        uniq, cmap = np.unique(rep, return_inverse=True)
        n_new = len(uniq)
        if n_new >= n_cur:  # no progress (isolated nodes only)
            break
        cmap_total = cmap[cmap_total]
        cu, cv = cmap[u], cmap[v]
        keep = cu != cv
        cu, cv, w = cu[keep], cv[keep], w[keep]
        key = cu * n_new + cv
        uk, inv2 = np.unique(key, return_inverse=True)
        w = np.bincount(inv2, weights=w).astype(np.int64)
        u, v = uk // n_new, uk % n_new
        n_cur = n_new

    # isolated-node-heavy graphs can exit the loop with n_cur still large;
    # the dense density matrix below would then be O(n_cur^2) bytes
    if n_cur > 8192:
        return _bfs_order(n_nodes, edge_src, edge_dst)

    # greedy linear arrangement of the coarse supernodes by density
    wmat = np.zeros((n_cur, n_cur))
    np.add.at(wmat, (u, v), w)
    sizes = np.bincount(cmap_total, minlength=n_cur).astype(np.float64)
    dens = wmat / np.maximum(np.outer(sizes, sizes), 1.0)
    first = int(np.argmax(sizes))
    chain = [first]
    unvisited = set(range(n_cur)) - {first}
    vis_aff = dens[first].copy()
    while unvisited:
        last = chain[-1]
        cand = max(unvisited, key=lambda j: dens[last, j])
        if dens[last, cand] == 0.0:
            cand = max(unvisited, key=lambda j: vis_aff[j])
        chain.append(cand)
        unvisited.discard(cand)
        vis_aff += dens[cand]
    rank = np.empty(n_cur, np.int64)
    rank[np.array(chain)] = np.arange(n_cur)
    return np.lexsort((np.arange(n_nodes), rank[cmap_total]))


def bfs_locality_order(n_nodes: int, edge_src: np.ndarray,
                       edge_dst: np.ndarray) -> np.ndarray:
    """``locality_order(..., method='bfs')``."""
    return _bfs_order(n_nodes, edge_src, edge_dst)


def _bfs_order(n_nodes: int, edge_src: np.ndarray,
               edge_dst: np.ndarray) -> np.ndarray:
    # CSR over the undirected adjacency
    u = np.concatenate([edge_src, edge_dst])
    v = np.concatenate([edge_dst, edge_src])
    deg = np.bincount(u, minlength=n_nodes)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    adj = v[np.argsort(u, kind="stable")].astype(np.int64)

    order = np.empty(n_nodes, np.int64)
    seen = np.zeros(n_nodes, bool)
    w = 0
    for seed in np.argsort(-deg, kind="stable"):
        if seen[seed]:
            continue
        seen[seed] = True
        order[w] = seed
        head = w
        w += 1
        while head < w:
            node = order[head]
            head += 1
            for nb in adj[indptr[node]:indptr[node + 1]]:
                if not seen[nb]:
                    seen[nb] = True
                    order[w] = nb
                    w += 1
    assert w == n_nodes
    return order


def partition_typed_graph(
    n_nodes: int,
    node_type: np.ndarray,
    x: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_type: np.ndarray,
    n_devices: int,
    node_graph: Optional[np.ndarray] = None,
    n_graphs: int = 1,
    pad_edge_type: int = 63,
    node_y: Optional[np.ndarray] = None,
    n_types: Optional[int] = None,
    drop_cross: bool = False,
    min_caps: Optional[dict] = None,
    force_pull: bool = False,
) -> HaloPartition:
    """Host-side partitioner: contiguous node ranges with DEGREE-AWARE
    cut points (each shard owns ~equal adjacency volume), hybrid
    pull/push cross-shard plans chosen per (src-owner, dst-owner) pair by
    min(#unique remote sources, #unique (dst,type) cells), and the two
    sorted edge streams per shard.

    ``drop_cross=True`` keeps only intra-shard edges (no halo at all): a
    shape-comparable zero-communication control, NOT a correct partition
    of the graph. ``min_caps`` ({'n_loc','e_int','e_bnd','h_max','p_max'})
    floors the padded capacities so partitions of different graphs come
    out with identical shapes. ``force_pull=True`` disables push mode:
    every cross edge is resident at its DST owner (required by GAT's
    per-segment softmax and PNA's statistics)."""
    del pad_edge_type  # pads are out-of-range segment keys
    d = n_devices
    if n_types is None:
        n_types = int(edge_type.max()) + 1 if len(edge_type) else 1
    t = int(n_types)

    # equal-adjacency contiguous cuts over the (in+out)-degree prefix sum
    vol = np.bincount(edge_dst, minlength=n_nodes).astype(np.int64)
    vol += np.bincount(edge_src, minlength=n_nodes)
    csum = np.concatenate([[0], np.cumsum(vol + 1)])  # +1: node residency
    targets = np.arange(1, d) * (csum[-1] / d)
    cuts = np.searchsorted(csum, targets).astype(np.int64)
    starts = np.concatenate([[0], cuts, [n_nodes]])
    # enforce strictly increasing (>=1 node per shard): forward repair,
    # re-pin the end, backward repair
    for i in range(1, d + 1):
        starts[i] = max(starts[i], starts[i - 1] + 1)
    starts[d] = n_nodes
    for i in range(d - 1, 0, -1):
        starts[i] = min(starts[i], starts[i + 1] - 1)
    assert starts[0] == 0 and starts[-1] == n_nodes and np.all(
        np.diff(starts) >= 1), starts
    n_loc = int(((np.diff(starts).max() + 7) // 8) * 8)
    caps = min_caps or {}
    n_loc = max(n_loc, int(caps.get("n_loc", 0)))

    def owner_of(ids):
        return np.searchsorted(starts, ids, side="right") - 1

    owner_src = owner_of(edge_src)
    owner_dst = owner_of(edge_dst)
    if drop_cross:
        keep = owner_src == owner_dst
        edge_src, edge_dst = edge_src[keep], edge_dst[keep]
        edge_type = edge_type[keep]
        owner_src, owner_dst = owner_src[keep], owner_dst[keep]
    gseg = edge_dst.astype(np.int64) * t + edge_type.astype(np.int64)

    # per-pair mode decision + plans
    #   pull_ids[dev][p]: global src ids shard dev pulls from peer p
    #   push_cells[s][dev]: global (dst,type) cells s pushes to dev
    pull_ids = [[np.zeros(0, np.int64)] * d for _ in range(d)]
    push_cells = [[np.zeros(0, np.int64)] * d for _ in range(d)]
    cross = owner_src != owner_dst
    is_push_edge = np.zeros(len(edge_src), bool)
    for s in range(d):
        for dev in range(d):
            if s == dev:
                continue
            sel = cross & (owner_src == s) & (owner_dst == dev)
            if not sel.any():
                continue
            u_src = np.unique(edge_src[sel])
            u_cell = np.unique(gseg[sel])
            if not force_pull and len(u_cell) < len(u_src):
                push_cells[s][dev] = u_cell
                is_push_edge[sel] = True
            else:
                pull_ids[dev][s] = u_src
    h_max = max([1] + [len(pull_ids[dev][p])
                       for dev in range(d) for p in range(d)])
    h_max = ((h_max + 7) // 8) * 8
    h_max = max(h_max, int(caps.get("h_max", 0)))
    p_counts = [len(push_cells[s][dev]) for s in range(d) for dev in range(d)]
    p_max = max([0] + p_counts)
    p_max = ((p_max + 7) // 8) * 8  # 0 stays 0: no push pairs anywhere
    p_max = max(p_max, int(caps.get("p_max", 0)))

    send_idx = np.zeros((d, d, h_max), np.int32)
    send_mask = np.zeros((d, d, h_max), np.float32)
    for p in range(d):
        for dev in range(d):
            ids = pull_ids[dev][p]  # global ids owned by p, needed by dev
            loc = (ids - starts[p]).astype(np.int32)
            send_idx[p, dev, :len(loc)] = loc
            send_mask[p, dev, :len(loc)] = 1.0

    # receive side of the push plan: local cell targets per (dev, peer);
    # dead slots -> n_loc*t (out of range)
    push_tgt = np.full((d, d, p_max), n_loc * t, np.int32)
    for s in range(d):
        for dev in range(d):
            cells = push_cells[s][dev]
            if len(cells):
                push_tgt[dev, s, :len(cells)] = (
                    cells - starts[dev] * t).astype(np.int32)

    # node tables
    f_dim = x.shape[1]
    X = np.zeros((d, n_loc, f_dim), np.float32)
    NT = np.zeros((d, n_loc), np.int32)
    NM = np.zeros((d, n_loc), np.float32)
    NG = np.zeros((d, n_loc), np.int32)
    NY = (np.zeros((d, n_loc, node_y.shape[1]), np.float32)
          if node_y is not None else None)
    for dev in range(d):
        lo, hi = int(starts[dev]), int(starts[dev + 1])
        k = hi - lo
        X[dev, :k] = x[lo:hi]
        NT[dev, :k] = node_type[lo:hi]
        NM[dev, :k] = 1.0
        NG[dev, :k] = node_graph[lo:hi] if node_graph is not None else 0
        if NY is not None:
            NY[dev, :k] = node_y[lo:hi]
    NG[NM == 0] = n_graphs  # pad slot

    # edge residency: push edges live with the src owner, all others with
    # the dst owner; INTERIOR = edges with a locally owned source (intra
    # edges + all push edges), BOUNDARY = pull-mode cross edges
    res_dev = np.where(is_push_edge, owner_src, owner_dst)
    interior = is_push_edge | (owner_src == owner_dst)
    int_counts = np.bincount(res_dev[interior], minlength=d)
    bnd_counts = np.bincount(res_dev[~interior], minlength=d)
    e_int = int(max(128, ((int_counts.max() + 127) // 128) * 128))
    e_int = max(e_int, int(caps.get("e_int", 0)))
    e_bnd = int(((max(bnd_counts.max(), 0) + 127) // 128) * 128)
    e_bnd = max(e_bnd, int(caps.get("e_bnd", 0)))

    seg_total = n_loc * t + d * p_max
    ESI = np.full((d, e_int), 0, np.int32)
    ESEGI = np.full((d, e_int), seg_total, np.int32)
    ESB = np.full((d, e_bnd), 0, np.int32)
    ESEGB = np.full((d, e_bnd), n_loc * t, np.int32)
    for dev in range(d):
        sel = res_dev == dev
        es, ed, et = edge_src[sel], edge_dst[sel], edge_type[sel]
        so, do = owner_src[sel], owner_dst[sel]
        push = is_push_edge[sel]
        m = len(es)
        seg = np.empty(m, np.int64)
        # local-destination edges: ordinary (dst,type) cells
        loc = ~push
        seg[loc] = (ed[loc] - starts[dev]).astype(np.int64) * t + et[loc]
        # push edges: outgoing slot key per destination peer
        g = ed.astype(np.int64) * t + et
        for peer in np.unique(do[push]):
            sel2 = push & (do == peer)
            pos = np.searchsorted(push_cells[dev][peer], g[sel2])
            seg[sel2] = n_loc * t + peer * p_max + pos
        local_src = so == dev
        # interior stream: local source ids
        ii = np.nonzero(local_src)[0]
        order = np.argsort(seg[ii], kind="stable")
        ESI[dev, :len(ii)] = (es[ii] - starts[dev])[order]
        ESEGI[dev, :len(ii)] = seg[ii][order]
        # boundary stream: halo-table source ids per source peer
        bb = np.nonzero(~local_src)[0]
        src_halo = np.empty(len(bb), np.int64)
        for p in range(d):
            sel2 = so[bb] == p
            if not sel2.any():
                continue
            pos = np.searchsorted(pull_ids[dev][p], es[bb][sel2])
            src_halo[sel2] = p * h_max + pos
        order = np.argsort(seg[bb], kind="stable")
        ESB[dev, :len(bb)] = src_halo[order]
        ESEGB[dev, :len(bb)] = seg[bb][order]
        # pad edges gather row 0 of their table (result dropped) and
        # carry an out-of-range key, so the segment sums drop them

    return HaloPartition(
        x=X, node_type=NT, node_mask=NM, node_graph=NG,
        edge_src_int=ESI, edge_seg_int=ESEGI,
        edge_src_bnd=ESB, edge_seg_bnd=ESEGB,
        send_idx=send_idx, send_mask=send_mask, push_tgt=push_tgt,
        node_y=NY, n_graphs=n_graphs, n_types=t,
        node_range=np.stack([starts[:-1], starts[1:]], 1).astype(np.int64))


# ---------------------------------------------------------- shards placed
@dataclasses.dataclass
class HaloShard:
    """One shard of a ``HaloPartition`` on its device: the partition's
    slices as int32 / f32 tensors, plus what the layers read without
    deriving it again (``place_shards``)."""

    index: int
    device: torch.device
    n_devices: int
    n_types: int
    x: torch.Tensor             # [n_loc, F] f32
    node_type: torch.Tensor     # [n_loc] i32
    node_mask: torch.Tensor     # [n_loc] f32
    node_graph: torch.Tensor    # [n_loc] i32
    node_y: Optional[torch.Tensor]  # [n_loc, Q] f32
    # [D, p_max] i64: the cell each received push slot adds into, dead
    # slots sent to spill row n_loc*T + slot (distinct, cut off after)
    push_rows: torch.Tensor
    # the pull plan as one-type streams over the D*h_max send slots of
    # the local rows, one edge per live slot (send_idx, send_mask); the
    # interior stream (edge_src_int, edge_seg_int) over n_loc*T + D*p_max
    # segments of the local rows; the boundary stream (edge_src_bnd,
    # edge_seg_bnd) over n_loc*T segments of the D*h_max halo rows (None
    # when it is empty)
    send: TypedStreams
    interior: TypedStreams
    boundary: Optional[TypedStreams]
    # node_graph ascends (pooling runs K1 over it)
    graph_sorted: bool
    # [n_loc, 2]: the in-degrees per direction bit of a gossip partition,
    # kept by ``halo_direction_degrees`` at its first call
    direction_deg: Optional[torch.Tensor] = None
    # which rank holds each slot of the list, where some slot is another
    # rank's (None: this process holds every slot)
    ranks: Optional["SlotRanks"] = None

    @property
    def n_loc(self) -> int:
        return self.x.shape[0]

    @property
    def h_max(self) -> int:
        return self.send.n_nodes // self.n_devices

    @property
    def p_max(self) -> int:
        return self.push_rows.shape[-1]


@dataclasses.dataclass(frozen=True)
class SlotRanks:
    """The ranks of a shard list that spans processes: ``of[d]`` holds
    slot d; ``members``, the ranks it spans in order; ``group``, their
    process group (None: the default one)."""

    of: tuple
    members: tuple
    group: object = None

    def slots(self, rank: int) -> List[int]:
        """The slots ``rank`` holds, in order."""
        return [d for d, r in enumerate(self.of) if r == rank]


def local_shards(shards: list) -> List[HaloShard]:
    """The shards this process holds, in slot order."""
    return [sh for sh in shards if sh is not None]


def spans_ranks(shards: list) -> bool:
    """Whether another rank holds some slot of ``shards``."""
    return any(sh is None for sh in shards)


def shard_devices(n_devices: int, device) -> List[torch.device]:
    """The devices the shards cycle over: the CPU for a CPU ``device``,
    else every visible CUDA device. ``n_devices`` (shards) 0 means one
    per visible CUDA device (one on the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * (n_devices or 1)
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if not visible:
        raise RuntimeError("no CUDA device is visible for the halo shards")
    if not n_devices:
        return visible
    return [visible[d % len(visible)] for d in range(n_devices)]


def place_shards(part: HaloPartition, devices,
                 ranks: Optional[Sequence[int]] = None
                 ) -> List[Optional[HaloShard]]:
    """Move a partition onto its devices: shard d on ``devices[d %
    len(devices)]`` (``shard_devices`` gives one per shard), int32 index
    and f32 value tensors, with the interior and boundary
    ``TypedStreams`` derived once (the source-sorted backward streams are
    derived on the device where a backward first needs them).

    ``ranks`` (in a process group): ``ranks[d]`` is the rank that holds
    shard d; this rank places its own and leaves None for the others.
    The ranks must ascend over the slots (desco_tpu's devices are
    process-major). Where they are not every rank, their process group
    must have been made on every rank first (``distributed.group_of``;
    ``topology.make_mesh2d`` makes its rows'). This rank must hold a slot:
    ranks that leave it none raise. Without ``ranks`` this process holds
    every shard."""
    d_n, t, n_loc = part.n_devices, part.n_types, part.n_loc
    layout = None
    if ranks is not None:
        ranks = tuple(int(r) for r in ranks)
        if len(ranks) != d_n or list(ranks) != sorted(ranks):
            raise ValueError(f"ranks {ranks} for {d_n} shards: one per "
                             f"shard, ascending")
        if ranks[0] < 0 or ranks[-1] >= distributed.world():
            raise ValueError(f"ranks {ranks}: the group has "
                             f"{distributed.world()} ranks")
        if distributed.rank() not in ranks:
            raise ValueError(f"rank {distributed.rank()} holds no slot of "
                             f"ranks {ranks}: a rank places only the shard "
                             f"lists it holds a slot of (a grid's other "
                             f"rows are None, topology.place_replicas)")
        if set(ranks) != {distributed.rank()}:
            members = tuple(sorted(set(ranks)))
            layout = SlotRanks(ranks, members,
                               distributed.group_of(members))
    shards = []
    for d in range(d_n):
        if layout is not None and layout.of[d] != distributed.rank():
            shards.append(None)
            continue
        dev = torch.device(devices[d % len(devices)])

        def put(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a[d]),
                                   dtype=dtype).to(dev)

        src_i, seg_i = put(part.edge_src_int), put(part.edge_seg_int)
        src_b, seg_b = put(part.edge_src_bnd), put(part.edge_seg_bnd)
        live = part.send_mask[d].reshape(-1) > 0
        send_src = torch.as_tensor(
            part.send_idx[d].reshape(-1)[live]).to(dev)
        send_slot = torch.as_tensor(
            np.nonzero(live)[0].astype(np.int32)).to(dev)
        tgt = part.push_tgt[d].astype(np.int64)
        spill = n_loc * t + np.arange(part.p_max, dtype=np.int64)
        push_rows = np.where(tgt < n_loc * t, tgt, spill[None, :])
        shards.append(HaloShard(
            index=d, device=dev, n_devices=d_n, n_types=t,
            x=put(part.x, torch.float32), node_type=put(part.node_type),
            node_mask=put(part.node_mask, torch.float32),
            node_graph=put(part.node_graph),
            node_y=(None if part.node_y is None
                    else put(part.node_y, torch.float32)),
            push_rows=torch.as_tensor(push_rows).to(dev),
            send=typed_streams(send_src, send_slot, 1, d_n * part.h_max,
                               n_loc),
            interior=typed_streams(src_i, seg_i, 1,
                                   n_loc * t + d_n * part.p_max, n_loc),
            boundary=(typed_streams(src_b, seg_b, 1, n_loc * t,
                                    d_n * part.h_max)
                      if src_b.shape[0] else None),
            graph_sorted=bool(np.all(np.diff(part.node_graph[d]) >= 0)),
            ranks=layout))
    return shards


# ----------------------------------------------------------- exchanges
def _route(blocks: List[torch.Tensor], shards: list,
           anchors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """desco_tpu's ``all_to_all`` over the shards: ``blocks`` holds, per
    shard this process holds, a [D, ...] tensor whose block r goes to
    slot r. Returns per local receiver the D blocks it gets, block p from
    slot p, on its device. Between two local shards a block is a device
    copy; between ranks every block goes in one ``exchange_blocks``,
    recorded in autograd where the ``anchors`` (the shards' layer inputs)
    require grad."""
    loc = local_shards(shards)
    sent = {sh.index: b for sh, b in zip(loc, blocks)}
    remote = (_cross_rank(blocks, loc, anchors) if spans_ranks(shards)
              else {})
    return [[sent[p][sh.index].to(sh.device) if p in sent
             else remote[p, sh.index] for p in range(len(shards))]
            for sh in loc]


def _cross_rank(blocks: List[torch.Tensor], loc: List[HaloShard],
                anchors: List[torch.Tensor]) -> dict:
    """The blocks between this rank's shards and other ranks' in one
    collective: to each other member rank q, the blocks from this rank's
    shards to q's (sender, then receiver, in slot order); nothing to this
    rank itself. Returns {(sender slot, receiver slot): block} for every
    remote sender and local receiver."""
    layout, me = loc[0].ranks, distributed.rank()
    dev = loc[0].device
    send, n_in, n_out = [], [], []
    for q in layout.members:
        peers = [] if q == me else layout.slots(q)
        send += [b[j].to(dev) for b in blocks for j in peers]
        n_in.append(len(blocks) * len(peers))
        n_out.append(len(peers) * len(loc))
    recv = iter(distributed.exchange_blocks(
        torch.stack(send), layout.group, anchors, counts=(n_in, n_out)))
    return {(p, sh.index): next(recv).to(sh.device)
            for q in layout.members if q != me
            for p in layout.slots(q) for sh in loc}


def halo_exchange(xs: List[torch.Tensor],
                  shards: list) -> List[torch.Tensor]:
    """The pull exchange: every shard sends ``x[send_idx] * send_mask``
    to each peer. Returns each local receiver's halo table [D*h_max, F],
    block p the rows received from shard p (desco_tpu's ``all_to_all``).
    The send gather is the gather-fused K1 over the live send slots (dead
    slots are zero rows), so its backward, which sums a row's cotangents
    over the peers it went to, is K1 over the source-sorted slots: no
    atomic ``index_add_``, the same bits every run. ``xs``: one per shard
    this process holds."""
    sends = [_stream_sum(x, sh.send).view(sh.n_devices, sh.h_max,
                                          x.shape[1])
             for x, sh in zip(xs, local_shards(shards))]
    return [torch.cat(got) for got in _route(sends, shards, xs)]


def psum(values: List[torch.Tensor], shards: list) -> List[torch.Tensor]:
    """desco_tpu's ``psum`` over the shards: every slot's value (``values``
    one per shard this process holds) sent to every shard as the
    exchanges send (``_route``: across ranks too, differentiable), and
    added in slot order on each local shard's device."""
    out = []
    for got in _route([v.expand((len(shards),) + v.shape) for v in values],
                      shards, values):
        total = got[0]
        for v in got[1:]:
            total = total + v
        out.append(total)
    return out


def _stream_sum(x: torch.Tensor, st: TypedStreams) -> torch.Tensor:
    """One halo stream's sum [n_segments, H] in x's dtype: the
    gather-fused K1 on the card (its plain twin on the CPU), accumulated
    in f32; zeros, without a launch, for a stream without edges."""
    if st.edge_src.numel() == 0:
        return x.new_zeros((st.n_nodes * st.n_types, x.shape[1]))
    return gather_segment_sum(x, st).to(x.dtype)


def halo_typed_aggregate(xs: List[torch.Tensor], shards: list,
                         tag: str = "") -> List[torch.Tensor]:
    """Hybrid typed aggregation over the shards' resident edges: per
    shard this process holds (``xs`` one each) [n_loc, T, H], in
    desco_tpu's five steps:

      1. the PULL exchange (boundary rows);
      2. the INTERIOR stream's sum (local cells + outgoing push
         partials): no data dependence on step 1;
      3. the PUSH exchange of the partials from step 2;
      4. the BOUNDARY stream's sum over the received halo table, added
         into the local cells;
      5. the received push partials written into their cells, one peer
         at a time in peer order.

    Differentiable (halo training). The steps run in profiler ranges
    (halo_pull{tag}, halo_interior{tag}, ...), so
    parallel/overlap_check.py can check that no interior op reads a pull
    result and no boundary op a push result."""
    loc = local_shards(shards)
    t = loc[0].n_types
    d_n = len(shards)

    # (1) pull exchange first: nothing below reads it until (4)
    with torch.profiler.record_function(f"halo_pull{tag}"):
        halos = halo_exchange(xs, shards)

    # (2) interior stream: local sources only
    with torch.profiler.record_function(f"halo_interior{tag}"):
        combs = [_stream_sum(x, sh.interior) for x, sh in zip(xs, loc)]
    aggs = [c[:sh.n_loc * t] for c, sh in zip(combs, loc)]

    # (3) push exchange of the interior partials
    p_max = loc[0].p_max
    push_in = None
    if p_max:
        with torch.profiler.record_function(f"halo_push{tag}"):
            outs = [c[sh.n_loc * t:].view(d_n, p_max, c.shape[1])
                    for c, sh in zip(combs, loc)]
            # receiver r's [D, p_max, H]: block s from shard s
            push_in = [torch.stack(got)
                       for got in _route(outs, shards, xs)]

    # (4) boundary stream: sources in the received halo table (every
    # shard has one or none: the partition pads the streams alike)
    if loc[0].boundary is not None:
        with torch.profiler.record_function(f"halo_boundary{tag}"):
            aggs = [a + _stream_sum(h, sh.boundary)
                    for a, h, sh in zip(aggs, halos, loc)]

    # (5) received push partials, peer by peer; dead slots land in the
    # spill rows past the cells. Backward: index_select's index_add_,
    # atomic on the card but onto rows distinct within one peer
    if push_in is not None:
        out = []
        for a, parts, sh in zip(aggs, push_in, loc):
            a = torch.cat([a, a.new_zeros((p_max, a.shape[1]))])
            for s in range(d_n):
                rows = sh.push_rows[s]
                a = a.index_copy(0, rows, a.index_select(0, rows)
                                 + parts[s])
            out.append(a[:sh.n_loc * t])
        aggs = out
    return [a.reshape(sh.n_loc, t, a.shape[1])
            for a, sh in zip(aggs, loc)]


def halo_direction_degrees(shards: list) -> List[torch.Tensor]:
    """Per shard this process holds [n_loc, 2]: the in-degrees per
    direction bit of a gossip partition (tag ``_L100``, as desco_tpu's),
    through the same halo aggregation on 1-column rows. They depend on
    the partition alone: the first call computes them (every rank of a
    list that spans ranks at the same point), outside autograd and
    inference mode, and keeps them on the shards
    (``HaloShard.direction_deg``); later calls, training and serving
    alike, read those."""
    loc = local_shards(shards)
    if any(sh.direction_deg is None for sh in loc):
        with torch.inference_mode(False), torch.no_grad():
            aggs = halo_typed_aggregate(
                [sh.node_mask[:, None] for sh in loc], shards,
                tag="_L100")
        for sh, a in zip(loc, aggs):
            sh.direction_deg = a[..., 0]
    return [sh.direction_deg for sh in loc]


# ------------------------------------------------------------ SHMP tower
def halo_aggregator(cfg: SHMPConfig, shards: list):
    """The SAGE / GIN / GCN aggregation over the shards: per layer the
    hybrid exchange and typed aggregate, then the per-type transform."""
    n_types = local_shards(shards)[0].n_types
    if n_types != cfg.n_edge_types:
        raise ValueError(f"the partition has {n_types} edge "
                         f"types, the tower {cfg.n_edge_types}")

    def agg_fn(xs, conv_ws, layer):
        aggs = halo_typed_aggregate(xs, shards, tag=f"_L{layer}")
        return [torch.einsum("nth,thk->nk", a, w)
                for a, w in zip(aggs, conv_ws)]
    return agg_fn


def _require_pull_only(shards: list, conv: str, why: str) -> None:
    if any(sh.p_max for sh in local_shards(shards)):
        raise ValueError(f"halo {conv} needs a force_pull=True partition "
                         f"({why})")


def _edge_terms(seg, src, n, t_n):
    """(type, clamped destination, source) of a halo stream's edges, as
    int64; padding keys give an in-range garbage row that every sum drops."""
    seg = seg.long()
    et = torch.remainder(seg, t_n).clamp(0, t_n - 1)
    dst = torch.div(seg, t_n, rounding_mode="floor").clamp(max=n - 1)
    return et, dst, src.long()


def _streams(shard: HaloShard):
    """(keys, sources, table, offsets) per halo stream of a pull-only
    shard: the interior stream reads the local rows (table 0), the
    boundary stream the halo table (table 1); the offsets over the
    n_loc*T cells are the streams' own, derived once in ``place_shards``
    (with p_max = 0 the interior stream has no push slots)."""
    return [(st.keys, st.edge_src, tab, st.fwd_toffs)
            for tab, st in enumerate((shard.interior, shard.boundary))
            if st is not None]


def halo_gat_aggregator(cfg: SHMPConfig, shards: list, atts):
    """Typed GAT attention over the shards (``models/shmp_gnn
    .gat_aggregator`` semantics). Pull edges have a local destination, so
    each (dst, type) softmax is local once the raw remote rows arrive:
    the dst owner transforms its halo table and takes segment max, exp
    and sums over both streams. ``atts``: each shard's (a_src, a_dst)."""
    _require_pull_only(shards, "GAT", "push partials do not commute with "
                       "the per-(dst,type) softmax")
    t_n = cfg.n_edge_types

    def agg_fn(xs, conv_ws, layer):
        with torch.profiler.record_function(f"halo_pull_L{layer}"):
            halos = halo_exchange(xs, shards)
        out = []
        for x, halo, w, att, sh in zip(xs, halos, conv_ws, atts,
                                       local_shards(shards)):
            n = x.shape[0]
            n_seg = n * t_n
            a_src, a_dst = att[0][layer], att[1][layer]
            z = torch.matmul(x, w)                        # [T, n_loc, K]
            z_h = torch.matmul(halo, w)                   # [T, D*h, K]
            s_src = torch.einsum("tnk,tk->tn", z, a_src)
            s_dst = torch.einsum("tnk,tk->tn", z, a_dst)
            s_tab = (s_src, torch.einsum("tnk,tk->tn", z_h, a_src))
            z_tab = (z, z_h)
            terms = []
            for keys, src, tab, offs in _streams(sh):
                et, dst, src = _edge_terms(keys, src, n, t_n)
                s_e = F.leaky_relu(s_tab[tab][et, src] + s_dst[et, dst],
                                   0.2)
                terms.append((keys, et, src, tab, offs, s_e))
            # the segment max over both streams at once
            m = segment_max(torch.cat([s for *_, s in terms]),
                            torch.cat([k for k, *_ in terms]), n_seg)
            num = den = 0.0
            for keys, et, src, tab, offs, s_e in terms:
                p = torch.exp(s_e - segment_pick(m, keys, n_seg))
                z_src = z_tab[tab][et, src]               # [E, K]
                num_s, den_s = sorted_segment_sum_pair(
                    p[:, None] * z_src, p, keys, n_seg, offs)
                num, den = num + num_s, den + den_s
            out.append(gat_softmax_out(num, den, m, s_src, s_dst, z))
        return out
    return agg_fn


def halo_pna_aggregator(cfg: SHMPConfig, shards: list, mix_ws):
    """Typed PNA aggregation over the shards (``models/shmp_gnn
    .pna_aggregator`` semantics, its two-pass variance included): every
    (dst, type) statistic is local at the dst owner of a pull-only
    partition (counts and sums add over the two streams, min and max
    combine), and the degree normalizer delta, a mean over the graph's
    valid nodes, is summed over the shards so every shard scales alike.
    ``mix_ws``: each shard's pna_mix."""
    _require_pull_only(shards, "PNA", "per-(dst,type) statistics do not "
                       "commute with push partials")
    t_n = cfg.n_edge_types

    def agg_fn(xs, conv_ws, layer):
        with torch.profiler.record_function(f"halo_pull_L{layer}"):
            halos = halo_exchange(xs, shards)
        parts = []
        for x, halo, w, sh in zip(xs, halos, conv_ws, local_shards(shards)):
            n = x.shape[0]
            n_seg = n * t_n
            z_tab = (torch.matmul(x, w), torch.matmul(halo, w))
            rows = []
            for keys, src, tab, offs in _streams(sh):
                et, _, src = _edge_terms(keys, src, n, t_n)
                rows.append((keys, offs, z_tab[tab][et, src]))  # [E, K]
            cnt = sum(segment_counts(o) for _, o, _ in rows)
            d = cnt.clamp(min=1.0)[:, None]
            mean = sum(sorted_segment_sum(z.float(), k, n_seg, o)
                       for k, o, z in rows) / d
            var = 0.0
            for k, o, z in rows:
                dev_e = z.float() - sorted_gather(mean, k, n_seg, o)
                var = var + sorted_segment_sum(dev_e * dev_e, k, n_seg, o)
            var = var / d
            z_all = torch.cat([z for _, _, z in rows])
            k_all = torch.cat([k for k, _, _ in rows])
            parts.append((cnt, mean, var,
                          segment_max(z_all, k_all, n_seg, "amin"),
                          segment_max(z_all, k_all, n_seg, "amax"),
                          *pna_log_degree_sum(cnt, sh.node_mask.float())))
        # the graph's mean log-degree over its valid nodes: its parts
        # summed over the shards, so every shard scales alike
        lsums = psum([p[5] for p in parts], shards)
        valids = psum([p[6] for p in parts], shards)
        return [pna_mix(*p[:5], lsum, valid, mix_w[layer])
                for p, lsum, valid, mix_w in zip(parts, lsums, valids,
                                                  mix_ws)]
    return agg_fn


def shard_params(params, dtype, shards: list) -> list:
    """Each local shard's view of ``params`` (a module) cast to ``dtype``
    on its device, inside the graph. Where autograd records, each slot
    reads views of its own (no copy where the device and type are the
    parameters'), made in reverse slot order, so a backward to
    ``params`` adds the slots' terms in slot order (autograd runs the
    later-made node first); otherwise one cast per device."""
    loc = local_shards(shards)
    if torch.is_grad_enabled():
        return [map_params(params, lambda p, dev=sh.device:
                           p.to(dev, dtype).view_as(p))
                for sh in loc[::-1]][::-1]
    home = next(params.parameters()).device
    cache = {}
    for sh in loc:
        if sh.device not in cache:
            cache[sh.device] = cast_params(
                params, dtype, None if sh.device == home else sh.device)
    return [cache[sh.device] for sh in loc]


def shard_generators(shards: List[HaloShard], seed: int) -> list:
    """One dropout generator per shard this process holds, on its device,
    seeded from the step's seed and the shard index (desco_tpu folds the mesh position
    into its key: the two match in distribution only)."""
    return ShardGenerators().seed(shards, seed)


class ShardGenerators:
    """The dropout generators of a train step over shards: made at the
    first ``seed`` call and reseeded in place (``manual_seed``) at every
    later one, as ``shard_generators`` seeds them, so a captured step
    (utils/cuda_graphs.py) keeps them registered. ``gens``: the current
    ones."""

    def __init__(self):
        self.gens: List[torch.Generator] = []

    def seed(self, shards: list, seed: int) -> list:
        loc = local_shards(shards)
        devices = [sh.device for sh in loc]
        if [g.device for g in self.gens] != devices:
            self.gens = [torch.Generator(device=d) for d in devices]
        for g, sh in zip(self.gens, loc):
            g.manual_seed((int(seed) * 1_000_003 + sh.index) % (2 ** 63 - 1))
        return self.gens


def halo_shmp_core(params, cfg: SHMPConfig, shards: list,
                   train: bool = False, seed: Optional[int] = None
                   ) -> List[torch.Tensor]:
    """SHMP core over ONE sharded graph: per shard this process holds the
    concat-skip embeddings [n_loc, post_input_dim] in ``cfg.dtype``. The
    layer body is ``apply_shmp_core``'s (``run_shmp_layers_sharded``);
    only the aggregation differs: remote contributions arrive through
    fresh pull / push exchanges per layer. GAT and PNA need a
    ``force_pull`` partition. ``seed`` (training with dropout): each shard
    draws its masks from ``shard_generators``."""
    loc = local_shards(shards)
    sp = shard_params(params, cfg.dtype, shards)
    if cfg.conv_type == "GAT":
        agg = halo_gat_aggregator(cfg, shards, [p["att"] for p in sp])
    elif cfg.conv_type == "PNA":
        agg = halo_pna_aggregator(cfg, shards, [p["pna_mix"] for p in sp])
    else:
        agg = halo_aggregator(cfg, shards)
    xs, ntypes, nmasks = [], [], []
    for sh, p in zip(loc, sp):
        nmask = sh.node_mask[:, None].to(cfg.dtype)
        x = _per_type_linear(sh.x.to(cfg.dtype), p["pre"].w, p["pre"].b,
                             sh.node_type, cfg.n_node_types)
        xs.append(x * nmask)
        ntypes.append(sh.node_type)
        nmasks.append(nmask)
    gens = (shard_generators(shards, seed)
            if train and seed is not None else None)
    return run_shmp_layers_sharded(sp, cfg, xs, ntypes, nmasks, agg,
                                   train=train, generators=gens)


def halo_graph_pool(embs: List[torch.Tensor], shards: list,
                    n_graphs: int) -> torch.Tensor:
    """Cross-shard global-add pool [n_graphs, H] on the first local
    shard's device: each shard's pooling sum (K1 over its ascending
    ``node_graph``, padding slot n_graphs dropped), then the sum over the
    shards (``psum``: across ranks too)."""
    loc = local_shards(shards)
    if not all(sh.graph_sorted for sh in loc):
        raise ValueError("halo pooling runs K1 over node_graph, which must "
                         "ascend within each shard")
    return psum([graph_pool_sum(e, sh.node_graph, n_graphs)
                 for e, sh in zip(embs, loc)], shards)[0]


# ---------------------------------------------------------------- gossip
def halo_gossip_single(params, shards: list,
                       x_cols: List[torch.Tensor], query_emb: torch.Tensor,
                       deg: Optional[List[torch.Tensor]] = None,
                       dropout: float = 0.0, train: bool = False,
                       generators=None) -> List[torch.Tensor]:
    """Gossip forward for ONE query over ONE sharded graph whose edge
    types are the direction bits (0 fwd / 1 bwd): per shard this process
    holds the residual [n_loc] (``models/gossip.apply_gossip_single``, its
    dropout points included), with the hybrid exchange feeding the
    per-direction aggregations. ``x_cols``: each local shard's stage-1
    counts of this query; ``deg``: ``halo_direction_degrees(shards)``,
    computed here when not given; ``generators``: one per local shard
    (``shard_generators``)."""
    return _gossip_single(shard_params(params, torch.float32, shards),
                          shards, x_cols, query_emb, deg, dropout, train,
                          generators)


def _gossip_single(sp: list, shards: list, x_cols, query_emb, deg,
                   dropout, train, generators) -> List[torch.Tensor]:
    """``halo_gossip_single`` on the local slots' parameter views ``sp``
    (``shard_params``)."""
    from ..models.gossip import _gate

    loc = local_shards(shards)
    qs = [query_emb.to(sh.device) for sh in loc]
    generators = generators or [None] * len(loc)
    nmasks = [sh.node_mask[:, None] for sh in loc]
    xs = []
    for p, sh, xc, q, nmask in zip(sp, loc, x_cols, qs, nmasks):
        x = p["pre"](xc[:, None])
        qe = q[None, :].expand(x.shape[0], q.shape[0])
        xs.append(torch.cat([qe, x], dim=-1).detach() * nmask)
    embs = [[x] for x in xs]
    if deg is None:
        deg = halo_direction_degrees(shards)
    for li in range(len(sp[0]["convs"])):
        aggs = halo_typed_aggregate(xs, shards, tag=f"_L{li}")
        new = []
        for p, x, agg, dg, q, nmask, gen in zip(sp, xs, aggs, deg, qs,
                                                nmasks, generators):
            conv = p["convs"][li]
            g = _gate(conv, q)
            mixed = g * agg[:, 0] + (1.0 - g) * agg[:, 1]
            wdeg = (g * dg[:, 0] + (1.0 - g) * dg[:, 1])[:, None]
            aggr = mixed @ conv["com"].w + conv["com"].b * wdeg
            x = conv["upd"](torch.cat([aggr, x], dim=-1))
            new.append(_dropout(torch.relu(x), dropout, train, gen) * nmask)
        xs = new
        for e, x in zip(embs, xs):
            e.append(x)
    return [_apply_post(p["post"], torch.cat(e, dim=-1), dropout, train,
                        gen)[:, 0] * sh.node_mask
            for p, e, sh, gen in zip(sp, embs, loc, generators)]


def _slot_sums(sp: list, shards: list, query_embs: torch.Tensor,
               dropout: float, train: bool, generators) -> list:
    """Per local shard slot, the gossip objective's sum over its valid
    nodes and the queries, in query order, on the slots' parameter views
    ``sp``."""
    loc = local_shards(shards)
    deg = halo_direction_degrees(shards)
    sums = [None] * len(loc)
    for q, q_emb in enumerate(query_embs):
        res = _gossip_single(sp, shards, [sh.x[:, q] for sh in loc], q_emb,
                             deg, dropout, train, generators)
        for i, (r, sh) in enumerate(zip(res, loc)):
            loss = (torch.log2((r + sh.x[:, q] - sh.node_y[:, q]).abs()
                               + 1.0) * sh.node_mask).sum()
            sums[i] = loss if sums[i] is None else sums[i] + loss
    return sums


def halo_gossip_loss(params, shards: list, query_embs: torch.Tensor,
                     dropout: float = 0.0, train: bool = False,
                     generators=None) -> torch.Tensor:
    """The gossip objective over ONE sharded graph
    (``models/gossip.gossip_loss``): the sum over queries and valid nodes
    of log2(|gossip + neigh - truth| + 1). Each shard's ``x`` holds the
    stage-1 counts [n_loc, Q], ``node_y`` the truth. desco_tpu's psum'd
    scalar: per shard slot the sum over its nodes and the queries in
    query order, the slots' sums added in slot order (``psum``: every
    rank's slots where the shards span ranks), on the first local
    shard's device. Its backward reaches the parameter reads of this
    process's shards: across ranks the slots' gradients are summed by the
    train step (``halo_gossip_step_fn``)."""
    sums = _slot_sums(shard_params(params, torch.float32, shards), shards,
                      query_embs, dropout, train, generators)
    return psum(sums, shards)[0]


def slot_terms(params, shards: list, query_embs: torch.Tensor,
               dropout: float = 0.0, generators=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[L, n + 1] on ``params``' device: per shard slot this process holds
    (L of them, in slot order), the gradient of the halo gossip loss with
    respect to the slot's own leaves of the parameters, flat in parameter
    order, then the slot's sum. One backward for all local slots: across
    ranks its exchanges carry the other ranks' cotangents. The rows of
    every slot added in slot order are the loss and its gradient.

    A slot's leaves share the parameters' storage where its shard lies on
    their device (a cast copy elsewhere), and their gradients accumulate
    into the slot's row itself: ``out`` (zeros, written in place) or a
    new buffer."""
    home = next(params.parameters()).device
    loc = local_shards(shards)
    sizes = [p.numel() for p in params.parameters()]
    rows = (out if out is not None
            else torch.zeros((len(loc), sum(sizes) + 1), device=home))
    trees, leaves = [], []
    for i, sh in enumerate(loc):
        own, off = {}, 0
        for p, n in zip(params.parameters(), sizes):
            t = p.detach().to(sh.device, torch.float32).requires_grad_()
            if t.device == home:
                t.grad = rows[i, off:off + n].view_as(p)
            own[id(p)] = t
            off += n
        trees.append(map_params(params, lambda p, own=own: own[id(p)]))
        leaves.append(list(own.values()))
    sums = _slot_sums(trees, shards, query_embs, dropout, dropout > 0.0,
                      generators)
    torch.autograd.backward(sums, [torch.ones_like(s) for s in sums],
                            inputs=[t for ts in leaves for t in ts])
    for i, (ts, s) in enumerate(zip(leaves, sums)):
        off = 0
        for t, n in zip(ts, sizes):
            if t.device != home and t.grad is not None:
                rows[i, off:off + n].copy_(t.grad.reshape(-1))
            off += n
        rows[i, -1].copy_(s.detach())
    return rows


def halo_gossip_step_fn(opt, dropout: float = 0.0, graphed: bool = False):
    """A gossip train step over a halo-partitioned graph:
    ``step(params, shards, query_embs, lr, seed) -> (loss, ok)``.
    Gradients flow through the exchanges; ``opt`` is the port's Adam
    (train/loop.py) over ``params``, applied with the finite-loss guard of
    ``train_step``. ``dropout`` > 0 draws masks from one generator per
    shard, made once and reseeded from ``seed`` at every call
    (``ShardGenerators``).

    The step's parts: each local slot's row [gradient of its own
    parameter leaves, its sum] (``slot_terms``); where the shards span
    ranks, the rows gathered in rank order (every rank holds the same
    number of slots, process-major, so rank order is slot order); then
    the rows added in slot order and Adam. Before them, once: where the
    shards span ranks, the check that every rank holds as many slots and
    the same parameters; the direction degrees. ``graphed``: the step is
    captured at the first call, for that call's ``params`` and
    ``shards``, and replayed at every later one
    (utils/cuda_graphs.placed_step_fn): one CUDA graph in one process,
    a chain of graphs split at the exchanges and the gather where the
    shards span ranks."""
    from .dp import apply_reduced, reduce_terms

    gens = ShardGenerators()
    state = {"spans": False, "checked": False}

    def reseed(shards, seed):
        return gens.seed(shards, seed) if dropout > 0.0 else []

    def prepare(shards):
        state["spans"] = spans_ranks(shards)
        if state["spans"]:
            _check_even(shards)
            if not state["checked"]:
                distributed.check_replicated(opt.flat, "parameters")
                state["checked"] = True
        halo_direction_degrees(shards)

    def local(params, shards, query_embs):
        return slot_terms(params, shards, query_embs, dropout,
                          gens.gens or None)

    def exchange(terms):
        return (distributed.gather_in_rank_order(terms) if state["spans"]
                else terms)

    def finish(terms, lr):
        loss, flat = reduce_terms(terms)
        return apply_reduced(opt, loss, flat, lr)

    return placed_step_fn(local, reseed, opt, graphed=graphed,
                          exchange=exchange, finish=finish, prepare=prepare)


def _check_even(shards: list) -> None:
    """A step across ranks gathers one row per slot from every rank of the
    group: its shards must span every rank, each holding as many."""
    layout = local_shards(shards)[0].ranks
    counts = {q: len(layout.slots(q)) for q in layout.members}
    if (layout.members != tuple(range(distributed.world()))
            or len(set(counts.values())) != 1):
        raise ValueError(f"a halo step across ranks needs every rank of "
                         f"the group to hold as many slots; the shards "
                         f"lie {counts} over {distributed.world()} ranks")


# --------------------------------------------------------------- serving
def serve_gossip_counts(gparams, graph, x_all: np.ndarray,
                        query_embs: torch.Tensor, n_devices: int = 0,
                        locality: str = "metis",
                        return_stats: bool = False, *, device,
                        graphed: bool = True):
    """Gossip-refined per-node counts for ONE large graph, halo-sharded
    (the entry for P2P/Astro-scale inputs). ``x_all``: [n_nodes, Q]
    stage-1 counts scattered to node rows (zeros for skipped nodes).
    Returns [n_nodes, Q] refined counts (residual + input) in f32,
    matching the packed ``gossip_predict``. ``device``: the device of
    ``gparams`` and ``query_embs``; the shards go to ``shard_devices
    (n_devices, device)``. The partition is uploaded once and every query
    reads it; the residuals come back once. ``return_stats`` adds
    {"n_loc", "n_devices", "partition_s", "gossip_s", "capture_s",
    "graphed"}: the most nodes a shard holds, the shards, the host seconds
    of ordering and partitioning and of the sharded forward (upload,
    capture and read-back included), the seconds of the capture within
    it, and whether the queries replayed a graph.

    ``graphed``: one query's forward over the placed shards
    (``halo_gossip_single``) is captured once per call, as desco_tpu makes
    ``jax.jit(run_one)`` per call (the partition is the graph's), its
    static inputs the query's stage-1 columns and embedding, the
    direction degrees computed before; every query replays it. Where the
    shards span several cards the exchanges copy across devices inside
    the forward, which one graph cannot record: it runs eagerly there and
    says so on standard error. On the CPU the
    same static buffers run without a capture.

    Direction bits are computed on ORIGINAL node ids (src < dst) before
    the locality relabeling, as the packed path has them."""
    from ..batch.build import gossip_sample

    t0 = time.perf_counter()
    devices = shard_devices(n_devices, device)
    d = len(devices)
    n = graph.n_nodes
    s = gossip_sample(graph, x_all.astype(np.float32))
    order = locality_order(n, s.edge_src, s.edge_dst, method=locality)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    part = partition_typed_graph(
        n, s.node_type[order], s.x[order],
        inv[s.edge_src].astype(np.int32), inv[s.edge_dst].astype(np.int32),
        s.edge_type, d, n_types=2)
    t1 = time.perf_counter()
    with torch.inference_mode():
        shards = place_shards(part, devices)
        deg = halo_direction_degrees(shards)

        def one_query(x_cols, q_emb):
            return halo_gossip_single(gparams, shards, x_cols, q_emb, deg)

        run, capture_s = one_query, 0.0
        one_card = len({sh.device for sh in shards}) == 1
        if graphed and not one_card:
            print(f"the halo gossip serve over {len(set(devices))} devices "
                  f"runs eager: a captured forward records one device",
                  file=sys.stderr, flush=True)
        elif graphed:
            compiled = GraphedStep(
                lambda xs: one_query(*xs),
                ([sh.x[:, 0] for sh in shards], query_embs[0]),
                capture=shards[0].device.type == "cuda", inference=True)
            capture_s = compiled.capture_s

            def run(x_cols, q_emb):
                return clone_outputs(compiled((x_cols, q_emb)))
        cols = [[] for _ in shards]
        for qi, q_emb in enumerate(query_embs):
            res = run([sh.x[:, qi] for sh in shards], q_emb)
            for c, r in zip(cols, res):
                c.append(r)
        resid = np.stack([torch.stack(c, dim=1).cpu().numpy()
                          for c in cols])                 # [D, n_loc, Q]
    x_loc = s.x[order]
    refined = unpartition_nodes(part, resid) + x_loc
    out = np.empty_like(refined)
    out[order] = refined
    if return_stats:
        return out, {"n_loc": int(part.n_loc), "n_devices": d,
                     "partition_s": t1 - t0,
                     "gossip_s": time.perf_counter() - t1,
                     "capture_s": capture_s,
                     "graphed": run is not one_query}
    return out
