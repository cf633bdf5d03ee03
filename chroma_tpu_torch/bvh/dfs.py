"""Stackless traversal layout: DFS preorder + escape indices.

The reference traverses its layered BVH with an explicit per-thread stack
(reference: chroma/cuda/mesh.h:45-126). A per-lane stack is hostile to a
vector machine, so for the TPU we re-lay the tree into depth-first preorder
with an "escape" pointer per node:

  * internal node hit  -> next = idx + 1        (first child is adjacent)
  * miss or leaf       -> next = escape[idx]    (skip the whole subtree)

Traversal state per photon collapses to a single node index, making the
inner loop one gather + a handful of VPU ops per step, fully lockstep
across the photon batch. This function derives that layout from a
reference-format layered BVH; the result is cached alongside the BVH.
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.bvh.bvh import CHILD_BITS

CHILD_MASK = np.uint32((1 << CHILD_BITS) - 1)


def _children(nodes_w):
    child = nodes_w & CHILD_MASK
    nchild = nodes_w >> np.uint32(CHILD_BITS)
    return child.astype(np.int64), nchild.astype(np.int64)


def flatten_to_dfs(bvh):
    """Re-lay a layered BVH into DFS preorder with escape indices.

    Returns (dfs_nodes, escape):
      dfs_nodes: (M,4) uint32 — packed AABB in x/y/z words; w holds nchild
        in the top 4 bits, and for leaves (nchild==0) the triangle index in
        the low 28 bits.
      escape: (M,) int32 — preorder index of the next node once this node's
        subtree is skipped (== M when the traversal is finished).
    """
    nodes = bvh.nodes
    n = len(nodes)
    w = nodes['w']
    child, nchild = _children(w)
    layer_bounds = bvh.layer_bounds

    # --- subtree sizes, bottom-up over layers (children always live in
    # strictly deeper layers, even after chain collapsing) ---
    size = np.ones(n, dtype=np.int64)
    for li in range(len(layer_bounds) - 2, -1, -1):
        a, b = layer_bounds[li], layer_bounds[li + 1]
        idx = np.arange(a, b)
        internal = nchild[a:b] > 0
        if not internal.any():
            continue
        prefix = np.concatenate([[0], np.cumsum(size)])
        ii = idx[internal]
        c = child[ii]
        k = nchild[ii]
        size[ii] = 1 + prefix[c + k] - prefix[c]

    m = int(size[0])

    # --- preorder positions, top-down (expand only reachable nodes) ---
    pos = np.full(n, -1, dtype=np.int64)
    pos[0] = 0
    for li in range(len(layer_bounds) - 2):
        a, b = layer_bounds[li], layer_bounds[li + 1]
        sel = (pos[a:b] >= 0) & (nchild[a:b] > 0)
        if not sel.any():
            continue
        parents = np.arange(a, b)[sel]
        c = child[parents]
        k = nchild[parents]
        total = int(k.sum())

        # indices of all children, groups concatenated
        group_ends = np.cumsum(k)
        group_starts = group_ends - k
        intra = np.arange(total) - np.repeat(group_starts, k)
        children_idx = np.repeat(c, k) + intra

        # position of each child: parent_pos + 1 + sum of earlier siblings
        child_sizes = size[children_idx]
        cs = np.cumsum(child_sizes) - child_sizes
        cs -= np.repeat(cs[group_starts], k)
        pos[children_idx] = np.repeat(pos[parents] + 1, k) + cs

    reachable = pos >= 0

    # --- emit DFS arrays ---
    dfs_nodes = np.zeros((m, 4), dtype=np.uint32)
    escape = np.empty(m, dtype=np.int32)

    src = np.flatnonzero(reachable)
    dst = pos[src]
    dfs_nodes[dst, 0] = nodes['x'][src]
    dfs_nodes[dst, 1] = nodes['y'][src]
    dfs_nodes[dst, 2] = nodes['z'][src]
    # w: keep nchild bits; low bits = triangle id for leaves, 0 for internal
    is_leaf = nchild[src] == 0
    low = np.where(is_leaf, w[src] & CHILD_MASK, 0).astype(np.uint32)
    dfs_nodes[dst, 3] = (nchild[src].astype(np.uint32)
                         << np.uint32(CHILD_BITS)) | low
    escape[dst] = (pos[src] + size[src]).astype(np.int32)

    return dfs_nodes, escape


def validate_dfs(dfs_nodes, escape):
    """Sanity-check a DFS layout: escape indices are strictly increasing
    past each node and never exceed M."""
    m = len(dfs_nodes)
    assert (escape > np.arange(m)).all(), 'escape must move forward'
    assert (escape <= m).all(), 'escape out of range'
    nchild = dfs_nodes[:, 3] >> CHILD_BITS
    leaf = nchild == 0
    # a leaf's subtree is itself
    assert (escape[leaf] == np.arange(m)[leaf] + 1).all()
