"""Which part of K2 and K3 (``csrc/typed_aggregate.cu``) costs on the GPU:
the kernels rebuilt with their gather, their products or both switched
off, timed against the shipped build at the main-path batches.

    python -m desco_tpu_torch.tools.typed_aggregate_parts [--seed 0]

Variants, made from the committed source by replacing one guard each
(``variant_sources``; a guard that is not found raises, so the tool
follows the source or fails):

  full         the shipped kernels
  no_gather    the tiles are not gathered (the products multiply whatever
               the shared tiles hold)
  no_products  the tiles are gathered, the mma loops are skipped
  neither      offsets, hand-overs between the warps, the W copy and the
               output writes only

Every variant but ``full`` computes a wrong result by design: this is a
timing probe. Each is timed as 8 launches in one CUDA graph
(``segsum_inner_ablation.graph_us``) on the batches of
``segsum_inner_ablation._own_cases``: K2 at a serving target batch, K3 at
a training batch, f32 and bf16. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
from typing import Dict

import torch

from ..ops import cuda_build
from ..ops import cuda_segment as cs

# (guard in the source, what replaces it) per switched-off part
_GATHER = [("if (offs_s[0] != offs_s[kBM * n_types])\n        gather_tile<T>",
            "if (false)\n        gather_tile<T>"),
           ("if (!empty)\n        gather_tile<T>",
            "if (false)\n        gather_tile<T>")]
_PRODUCTS = [("if (!empty && mma_warp) {", "if (false) {"),
             ("if (!empty && dx_warp) {", "if (false) {"),
             ("if (!empty && dw_warp) {", "if (false) {")]
VARIANTS = {"full": [], "no_gather": _GATHER, "no_products": _PRODUCTS,
            "neither": _GATHER + _PRODUCTS}


def variant_sources() -> Dict[str, str]:
    """{variant: CUDA source} from the committed typed_aggregate.cu."""
    with open(cs.TYPED_SOURCE) as f:
        src = f.read()
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: guard {old!r} not found once in "
                                   f"{cs.TYPED_SOURCE}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(name: str, text: str) -> str:
    digest = hashlib.sha1(text.encode()).hexdigest()[:12]
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, f"parts-{name}-{digest}.cu")
    so = src[:-3] + ".so"
    if not os.path.exists(so):
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return so


@contextlib.contextmanager
def _using(so: str):
    """The K2 / K3 wrappers launch from ``so`` inside the block."""
    cs.typed_library()  # sets the argument types of the shipped build
    shipped = cs._libs[cs.TYPED_STEM]
    lib = ctypes.CDLL(so)
    for name in ("desco_typed_aggregate_fwd",
                 "desco_typed_aggregate_bwd_blocks",
                 "desco_typed_aggregate_bwd",
                 "desco_typed_aggregate_dw_reduce"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = getattr(shipped, name).argtypes
    cs._libs[cs.TYPED_STEM] = lib
    try:
        yield
    finally:
        cs._libs[cs.TYPED_STEM] = shipped


def time_parts(cases: dict) -> dict:
    """{variant: {"k2_f32": us, ...}}: K2's and K3's whole functions."""
    from .segsum_inner_ablation import graph_us

    sources = variant_sources()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        sos = dict(zip(sources, pool.map(_build, sources, sources.values())))
    out = {}
    for name, so in sos.items():
        row = {}
        with _using(so):
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                c = cases["k2"]
                x, w, st = c["x"].to(dtype), c["w"].to(dtype), c["st"]
                row[f"k2_{dname}"] = graph_us(
                    lambda i: cs.fused_typed_transform_aggregate(
                        x, st.edge_src, st.keys, w, st.n_types, st.n_nodes,
                        streams=st))
                c = cases["k3"]
                x, w, st = c["x"].to(dtype), c["w"].to(dtype), c["st"]
                row[f"k3_{dname}"] = graph_us(
                    lambda i: cs.typed_aggregate_bwd(c["g"], x, w, st))
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.typed_aggregate_parts")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device
    from .segsum_inner_ablation import _own_cases

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    with torch.inference_mode():
        report = time_parts(_own_cases(device, args.seed))
    for name, row in report.items():
        print(f"{name:>12}: " + "  ".join(f"{k} {v:8.2f} us"
                                          for k, v in row.items()),
              flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "parts": report}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
