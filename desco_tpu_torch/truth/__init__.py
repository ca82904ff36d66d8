from .vf2 import canonical_counts, symmetric_factor, count_induced_embeddings
