"""chroma_tpu_torch.bvh: bounding volume hierarchy construction and layout
(host numpy). The DFS re-layout (chroma_tpu.bvh.dfs) is not copied: only
the JAX package's escape-pointer walk and its viewer read it."""
from chroma_tpu_torch.bvh.bvh import (BVH, BVHLayerSlice,  # noqa: F401
                                      WorldCoords, OutOfRangeError,
                                      CHILD_BITS, NCHILD_MASK, uint4,
                                      unpack_nodes, pack_nodes, node_areas)
from chroma_tpu_torch.bvh.build import (  # noqa: F401
    make_recursive_grid_bvh, make_simple_bvh, create_leaf_nodes,
    merge_nodes_detailed, concatenate_layers, collapse_chains)
