"""Memory pre-faulting (a copy of ``desco_tpu/utils/memory.py``).

Fresh anonymous pages fault in lazily, one at a time, on first touch;
on hosts where that path is slow, touching every page of a large
allocation up front from a thread pool turns scattered stalls inside
the packing loops into one bulk prefault.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PAGE = 4096
_THREADS = 32
_MIN_BYTES = 1 << 20  # smaller arrays are left to fault in on first use


def prefault(*arrays: np.ndarray, threads: int = _THREADS) -> None:
    """Touch every page of the given arrays in parallel."""
    views = []
    for a in arrays:
        if a is None or a.nbytes < _MIN_BYTES:
            continue
        flat = a.reshape(-1).view(np.uint8)
        views.append(flat)
    if not views:
        return
    total = sum(v.nbytes for v in views)
    n_chunks = max(threads, total // (64 << 20))
    jobs = []
    for v in views:
        step = max(v.nbytes // n_chunks, _MIN_BYTES)
        for lo in range(0, v.nbytes, step):
            jobs.append((v, lo, min(lo + step, v.nbytes)))

    def touch(job):
        v, lo, hi = job
        # read+write one byte per page (write forces a private fault)
        v[lo:hi:_PAGE] |= 0

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(touch, jobs))
