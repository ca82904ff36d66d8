"""desco_tpu_torch — the PyTorch/CUDA port of desco_tpu (serving and
training slices).

A second package beside ``desco_tpu``, which stays the reference and is
imported nowhere here. It serves and trains desco_tpu's models (the SAGE
SHMP neighborhood counter and the gossip refiner) on an NVIDIA GPU, with
the SHMP typed aggregation, the sorted segment-sum and their backward
passes as hand-written CUDA kernels (``ops/cuda_segment.py``,
``csrc/segment_sum.cu``). See ROADMAP.md for what is ported and what is
not yet.
"""

from .graph import Graph

__all__ = ["Graph"]
