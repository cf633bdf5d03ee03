"""chroma_tpu_torch.bvh: bounding volume hierarchy construction and layout
(host numpy): the classic layered BVH and what builds it, the DFS re-layout
that the escape-pointer walk (ops.mesh) reads, and the instanced wide table
(bvh.wide) that every device query traverses."""
from chroma_tpu_torch.bvh.bvh import (BVH, BVHLayerSlice,  # noqa: F401
                                      WorldCoords, OutOfRangeError,
                                      CHILD_BITS, NCHILD_MASK, uint4,
                                      unpack_nodes, pack_nodes, node_areas)
from chroma_tpu_torch.bvh.build import (  # noqa: F401
    make_recursive_grid_bvh, make_simple_bvh, create_leaf_nodes,
    merge_nodes_detailed, concatenate_layers, collapse_chains)
from chroma_tpu_torch.bvh.dfs import (flatten_to_dfs,  # noqa: F401
                                      validate_dfs)
