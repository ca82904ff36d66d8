from .container import Graph
from .canonical import Neighborhood, canonical_neighborhood, extract_all_neighborhoods
from .triangles import triangle_edge_mask
from .atlas import gen_query_ids, gen_queries, graph_atlas_plus
