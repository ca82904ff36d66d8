"""Digests of K1's and K4's outputs: whether two checkouts' kernels give
the same bits.

    python -m desco_tpu_torch.tools.kernel_digest [--seed 0]

Makes inputs with numpy from ``--seed`` at the shapes of the port's
uses on the main path: K1 at the target tower's graph pooling
(node embeddings [16768, 576] into 512 graphs, padding rows last), the
gather-fused K1 at the gossip layer-0 aggregation (x [15616, 128] over
the 31232 (node, direction) segments of a random edge stream) and its
backward over the source-sorted stream, and K4 behind the pooling (g
[512, 576] to [16768, 576]); and K1 on narrow rows (K = 1, 3 and 16
over 46,848 segments of 60,000 edges and one of 5,000, the gather-fused
K1 at one column over the gossip stream), each on f32 and on bf16 rows;
runs each through its wrapper on the card and prints one JSON line,
{case: sha256 of the output's bytes}. It calls only wrappers that the
port has had since the gather-fused K1 came, so a copy of this file run
from an older checkout digests that checkout's kernels: equal digests
are equal bits.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import torch

from ..ops import cuda_segment as cs

POOL_ROWS, POOL_GRAPHS, POOL_WIDTH = 16768, 512, 576
GOSSIP_NODES, GOSSIP_WIDTH, GOSSIP_EDGES = 15616, 128, 60000
PAD_KEY = 2 ** 30


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def cases(dev, seed: int) -> dict:
    """{case: a function that returns the output} for every wide case."""
    rng = np.random.default_rng(seed)
    out = {}
    graph = np.sort(rng.integers(0, POOL_GRAPHS, POOL_ROWS - 200))
    pool_ids = torch.as_tensor(np.concatenate(
        [graph, np.full(200, PAD_KEY)]).astype(np.int32), device=dev)
    pool_offs = cs.segment_offsets(pool_ids, POOL_GRAPHS)
    emb = torch.as_tensor(rng.standard_normal(
        (POOL_ROWS, POOL_WIDTH)).astype(np.float32), device=dev)
    g_pool = torch.as_tensor(rng.standard_normal(
        (POOL_GRAPHS, POOL_WIDTH)).astype(np.float32), device=dev)
    n, t = GOSSIP_NODES, 2
    src = rng.integers(0, n - 1, GOSSIP_EDGES)
    keys = rng.integers(0, n - 1, GOSSIP_EDGES) * t + rng.integers(
        0, t, GOSSIP_EDGES)
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(64, (n - 1) * t + 63)])
    src = np.concatenate([src[order], np.full(64, n - 1)])
    st = cs.ensure_backward_streams(cs.typed_streams(
        torch.as_tensor(src.astype(np.int32), device=dev),
        torch.as_tensor(keys.astype(np.int32), device=dev), t, n, n))
    x = torch.as_tensor(rng.standard_normal(
        (n, GOSSIP_WIDTH)).astype(np.float32), device=dev)
    n_narrow = 46848
    ids = np.sort(np.concatenate([rng.integers(0, n_narrow, 60000),
                                  np.full(5000, 99)]))
    narrow_ids = torch.as_tensor(np.concatenate(
        [ids, np.full(512, PAD_KEY)]).astype(np.int32), device=dev)
    narrow_offs = cs.segment_offsets(narrow_ids, n_narrow)
    narrow_x = torch.as_tensor(rng.standard_normal(
        (narrow_ids.shape[0], 16)).astype(np.float32), device=dev)
    g = torch.as_tensor(rng.standard_normal(
        (n * t, GOSSIP_WIDTH)).astype(np.float32), device=dev)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        e, xd = emb.to(dtype), x.to(dtype)
        out[f"k1_pool_{name}"] = (
            lambda e=e: cs.sorted_segment_sum(e, pool_ids, POOL_GRAPHS,
                                              pool_offs))
        out[f"k4_pool_{name}"] = (
            lambda dtype=dtype: cs.segment_sum_vjp(g_pool, pool_ids,
                                                   POOL_GRAPHS, dtype))
        out[f"k1g_fwd_{name}"] = lambda xd=xd: cs.gather_segment_sum(xd, st)
        out[f"k1g_bwd_{name}"] = (
            lambda dtype=dtype: cs.gather_segment_sum_bwd(g, st, dtype))
        for k in (1, 3, 16):
            m = narrow_x[:, :k].contiguous().to(dtype)
            out[f"k1_narrow_k{k}_{name}"] = (
                lambda m=m: cs.sorted_segment_sum(m, narrow_ids, n_narrow,
                                                  narrow_offs))
        deg = xd[:, :1].contiguous()
        out[f"k1g_degrees_{name}"] = (
            lambda deg=deg: cs.gather_segment_sum(deg, st))
    return out


def run(args) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_digest needs a CUDA device")
    dev = torch.device("cuda")
    with torch.inference_mode():
        res = {name: digest(fn()) for name, fn in cases(dev, args.seed)
               .items()}
    torch.cuda.synchronize()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    print(json.dumps(run(ap.parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
