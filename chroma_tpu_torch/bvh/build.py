"""BVH construction, fully vectorized in numpy (the torch port's copy of
chroma_tpu.bvh.build). The classic layered BVH is host-side only: the
port's device path traverses the instanced wide table (bvh.wide), which
uses morton_codes_3d from here.

The reference builds its BVH with CUDA helper kernels driven from Python
(reference: chroma/bvh/grid.py, chroma/gpu/bvh.py, chroma/cuda/bvh.cu).
Every step of that pipeline — leaf AABB quantization, Morton coding,
prefix grouping, child-union reduction, layer concatenation, chain
collapsing — is a data-parallel array transform, so here it is expressed
directly as numpy ufunc/reduceat operations with no device round trips.
The output node format and tree topology match the reference builder.
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.bvh.bvh import (BVH, WorldCoords, CHILD_BITS,
                                      NCHILD_MASK, uint4, pack_nodes,
                                      unpack_nodes)

MAX_CHILD = 2 ** (32 - CHILD_BITS) - 1


def spread3_16(x):
    """Spread the low 16 bits of each element so they occupy every third bit
    of the result (Morton interleave helper)."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x00000000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x000000F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x00000C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x0000249249249249)
    return x


def morton_codes_3d(q):
    "48-bit Morton codes from (n,3) quantized 16-bit coordinates."
    return (spread3_16(q[:, 0])
            | (spread3_16(q[:, 1]) << np.uint64(1))
            | (spread3_16(q[:, 2]) << np.uint64(2)))


def create_leaf_nodes(mesh, morton_bits=16, round_to_multiple=1):
    """Quantized leaf node per triangle plus its Morton code.

    Fixed-point scale puts the mesh extent in [0, 2^16-2]; leaf bounds are
    conservatively widened by one fixed-point unit on each side
    (reference: chroma/gpu/bvh.py:44-48, chroma/cuda/bvh.cu:148-203).

    Returns (world_coords, nodes, morton_codes).
    """
    vertices = mesh.vertices.astype(np.float64)
    world_origin = mesh.vertices.min(axis=0)  # float32, matches reference
    world_scale = np.max((mesh.vertices.max(axis=0) - world_origin)) \
        / (2 ** 16 - 2)
    world_coords = WorldCoords(world_origin=world_origin,
                               world_scale=world_scale)

    tri = vertices[mesh.triangles]              # (T,3,3)
    lower = tri.min(axis=1)
    upper = tri.max(axis=1)
    centroid = tri.mean(axis=1)

    def quantize(v):
        # truncating quantization, like the device builder
        return ((v - world_origin.astype(np.float64))
                / float(world_scale)).astype(np.uint32)

    q_lower = quantize(lower)
    q_upper = quantize(upper) + 1
    q_lower[q_lower > 0] -= 1
    q_centroid = quantize(centroid)

    morton = morton_codes_3d(q_centroid) >> np.uint64(16 - morton_bits)

    ntri = len(mesh.triangles)
    npad = -ntri % round_to_multiple
    nodes = pack_nodes(q_lower, q_upper,
                       np.arange(ntri, dtype=np.uint32),
                       np.zeros(ntri, dtype=np.uint32))
    if npad:
        nodes = np.concatenate([nodes, np.zeros(npad, dtype=uint4)])
    return world_coords, nodes, morton


def _group_reduce_bounds(nodes, first_child, nchild):
    """Union the AABBs of contiguous child groups.

    Returns packed parent nodes whose w encodes (nchild, first_child)."""
    lower = np.empty((len(nodes), 3), dtype=np.uint32)
    upper = np.empty((len(nodes), 3), dtype=np.uint32)
    for i, axis in enumerate('xyz'):
        lower[:, i] = nodes[axis] & 0xFFFF
        upper[:, i] = nodes[axis] >> 16

    starts = first_child.astype(np.intp)
    parent_lower = np.minimum.reduceat(lower, starts, axis=0)
    parent_upper = np.maximum.reduceat(upper, starts, axis=0)
    # reduceat segments implicitly end at the next start; validate coverage
    assert starts[0] == 0
    return pack_nodes(parent_lower, parent_upper, first_child, nchild)


def merge_nodes_detailed(nodes, first_child, nchild):
    """Merge children into parents given explicit grouping arrays
    (reference: chroma/gpu/bvh.py:84-112)."""
    return _group_reduce_bounds(nodes, np.asarray(first_child, np.uint32),
                                np.asarray(nchild, np.uint32))


def count_unique_in_sorted(a):
    return int((np.ediff1d(a) > 0).sum()) + 1


def make_recursive_grid_bvh(mesh, target_degree=3, verbose=False):
    """Build a BVH by recursive Morton-prefix grouping
    (reference: chroma/bvh/grid.py:11-95).

    Leaves (one per triangle) are Morton sorted; each round, Morton codes
    are right-shifted until the average group size reaches `target_degree`,
    equal codes become siblings (split at MAX_CHILD), and parents take the
    union of their children's bounds. Ends when one root remains.
    """
    world_coords, leaf_nodes, morton_codes = create_leaf_nodes(mesh)

    argsort = morton_codes.argsort()
    leaf_nodes = leaf_nodes[argsort]
    morton_codes = morton_codes[argsort]

    layers = [leaf_nodes]
    while len(layers[0]) > 1:
        top_layer = layers[0]
        nnodes = len(top_layer)

        nunique = count_unique_in_sorted(morton_codes)
        while nnodes / float(nunique) < target_degree and nunique > 1:
            morton_codes >>= np.uint64(1)
            nunique = count_unique_in_sorted(morton_codes)

        # group boundaries where the (shifted) morton code changes
        morton_delta = np.ediff1d(morton_codes,
                                  to_begin=np.uint64(1)).astype(np.uint64)
        parent_morton_codes = morton_codes[morton_delta > 0]
        first_child = np.flatnonzero(morton_delta > 0).astype(np.uint32)
        nchild = np.ediff1d(first_child,
                            to_end=nnodes - first_child[-1]).astype(np.uint32)

        if (nchild > MAX_CHILD).any():
            # split oversized groups into runs of at most MAX_CHILD children
            first_child, parent_morton_codes = _split_oversized_groups(
                first_child, nchild, parent_morton_codes, verbose)
            nchild = np.ediff1d(
                first_child, to_end=nnodes - first_child[-1]).astype(np.uint32)

        if verbose:
            print('Merging %d nodes to %d parents' % (nnodes, len(first_child)))

        assert (nchild > 0).all()
        assert (nchild <= MAX_CHILD).all()

        parents = merge_nodes_detailed(top_layer, first_child, nchild)
        layers = [parents] + layers
        morton_codes = parent_morton_codes

    nodes, layer_bounds = concatenate_layers(layers)
    nodes = collapse_chains(nodes, layer_bounds)
    return BVH(world_coords, nodes, layer_bounds[:-1])


def _split_oversized_groups(first_child, nchild, parent_morton_codes,
                            verbose=False):
    """Split any group with more than MAX_CHILD children into consecutive
    groups of at most MAX_CHILD, duplicating the group's Morton code."""
    excess = nchild > MAX_CHILD
    if verbose:
        print('Expanding %d parent nodes' % int(excess.sum()))
    nchild = nchild.astype(np.int64)
    nsplits = np.where(excess, -(-nchild // MAX_CHILD), 1).astype(np.int64)

    new_first = np.repeat(first_child.astype(np.int64), nsplits)
    # offset within each expanded group: 0, MAX_CHILD, 2*MAX_CHILD, ...
    group_ends = np.cumsum(nsplits)
    intra = np.arange(group_ends[-1]) - np.repeat(group_ends - nsplits,
                                                  nsplits)
    new_first = (new_first + intra * MAX_CHILD).astype(np.uint32)
    new_morton = np.repeat(parent_morton_codes, nsplits)
    return new_first, new_morton


def concatenate_layers(layers):
    """Concatenate per-layer node arrays root-first, offsetting each layer's
    child pointers to the absolute position of the next layer
    (reference: chroma/gpu/bvh.py:239-267). Returns (nodes, layer_bounds)."""
    layer_bounds = np.insert(np.cumsum(list(map(len, layers))), 0, 0)
    nodes = np.empty(int(layer_bounds[-1]), dtype=uint4)

    for layer_start, layer_end, layer in zip(layer_bounds[:-1],
                                             layer_bounds[1:], layers):
        dest = nodes[layer_start:layer_end]
        dest[:] = layer
        if layer_end != layer_bounds[-1]:
            # inner layer: children live at the start of the next layer
            nchild_bits = dest['w'] & np.uint32(0xF << CHILD_BITS)
            child = (dest['w'] & np.uint32((1 << CHILD_BITS) - 1)) \
                + np.uint32(layer_end)
            dest['w'] = nchild_bits | child
    return nodes, layer_bounds


def collapse_chains(nodes, layer_bounds):
    """Replace single-child nodes with their child, removing pointer chains
    (reference: chroma/gpu/bvh.py:114-130, chroma/cuda/bvh.cu:530-543).
    Processes layers bottom-up so chains collapse transitively."""
    nodes = nodes.copy()
    bounds = list(zip(layer_bounds[:-1], layer_bounds[1:]))[:-1]
    bounds.reverse()
    for start, end in bounds:
        view = nodes[start:end]
        nchild = view['w'] >> CHILD_BITS
        child = view['w'] & np.uint32((1 << CHILD_BITS) - 1)
        single = nchild == 1
        if single.any():
            view[single] = nodes[child[single]]
    return nodes


def make_simple_bvh(mesh, degree):
    """BVH from fixed-degree grouping of Morton-ordered leaves
    (reference: chroma/bvh/simple.py)."""
    world_coords, leaf_nodes, morton_codes = \
        create_leaf_nodes(mesh, round_to_multiple=degree)

    argsort = morton_codes.argsort()
    leaf_nodes[:len(argsort)] = leaf_nodes[argsort]
    assert len(leaf_nodes) % degree == 0

    layers = [leaf_nodes]
    while len(layers[0]) > 1:
        top = layers[0]
        nparent = -(-len(top) // degree)
        first_child = (np.arange(nparent, dtype=np.uint32)
                       * np.uint32(degree))
        # count real (non-padding) children per group
        padding = (top['x'] == 0)
        nchild = np.minimum(degree, len(top) - first_child).astype(np.uint32)
        # stop each group's count at its first padding node
        for g in range(nparent):
            run = padding[first_child[g]:first_child[g] + nchild[g]]
            hit = np.flatnonzero(run)
            if len(hit):
                nchild[g] = max(hit[0], 1)
        parent = _group_reduce_bounds(top, first_child, nchild)
        layers = [parent] + layers

    nodes, layer_bounds = concatenate_layers(layers)
    return BVH(world_coords, nodes, layer_bounds[:-1])


def _node_children(nodes):
    w = nodes['w'].astype(np.int64)
    return w & int(~NCHILD_MASK & 0xFFFFFFFF), w >> CHILD_BITS


def area_sort_nodes(nodes, layer_bounds):
    """Sort every node's children in place by descending bounding-box area,
    so traversals test big children first (reference: area_sort_child,
    chroma/cuda/bvh.cu:545-575; chroma/gpu/bvh.py:133-146)."""
    from chroma_tpu_torch.bvh.bvh import node_areas

    nodes = nodes.copy()
    child, nchild = _node_children(nodes)
    areas = node_areas(nodes)

    bounds = list(zip(layer_bounds[:-1], layer_bounds[1:]))[:-1]
    for start, end in bounds:
        internal = np.flatnonzero(nchild[start:end] > 0) + start
        if len(internal) == 0:
            continue
        counts = nchild[internal]
        seg_id = np.repeat(np.arange(len(internal)), counts)
        child_idx = np.concatenate(
            [np.arange(c, c + n) for c, n in zip(child[internal], counts)])
        # contiguous per-parent segments: lexsort by (segment, -area)
        perm = np.lexsort((-areas[child_idx], seg_id))
        nodes[child_idx] = nodes[child_idx[perm]]
    return nodes


def rebuild_above(bvh, layer_idx, degree=2):
    """Rebuild every layer above `layer_idx` by merging consecutive runs
    of `degree` nodes bottom-up, returning a new BVH. Needed after a
    within-layer reordering (optimize_layer) invalidates the parents'
    contiguous child runs. (The reference CLI calls an equivalent
    `rebuild_tree` that drifted out of its tree; reference:
    bin/chroma-bvh:84.)"""
    from chroma_tpu_torch.bvh.bvh import (BVH, pack_nodes, unpack_nodes,
                                          node_areas)

    lb = bvh.layer_bounds
    old_base = lb[layer_idx]
    kept = bvh.nodes[old_base:].copy()      # layer_idx..deepest, in order

    # sizes of the rebuilt upper layers (root first)
    sizes = []
    n = lb[layer_idx + 1] - lb[layer_idx]
    while n > 1:
        n = (n + degree - 1) // degree
        sizes.append(n)
    sizes.reverse()                          # [1, ..., parents-of-layer]
    new_base = sum(sizes)

    # kept nodes' absolute child pointers shift by the new prefix length
    delta = new_base - old_base
    if delta != 0:
        w = kept['w'].astype(np.int64)
        child = w & int(~NCHILD_MASK & 0xFFFFFFFF)
        nchild = w >> CHILD_BITS
        internal = nchild > 0
        child = np.where(internal, child + delta, child)
        kept['w'] = ((nchild << CHILD_BITS) | child).astype(np.uint32)

    # build parents bottom-up over the (reordered) layer
    layers = []                              # deepest-first
    u = unpack_nodes(kept[:lb[layer_idx + 1] - old_base])
    lo = np.stack([u['xlo'], u['ylo'], u['zlo']], axis=1).astype(np.int64)
    hi = np.stack([u['xhi'], u['yhi'], u['zhi']], axis=1).astype(np.int64)
    real = node_areas(kept[:lb[layer_idx + 1] - old_base]) > 0
    real |= (lo != hi).any(axis=1)           # dummies have zero extent
    child_abs = new_base                     # offset of the child layer
    for size in reversed(sizes):
        cnt = len(lo)
        pad = size * degree - cnt
        lo_p = np.concatenate([lo, np.zeros((pad, 3), np.int64)])
        hi_p = np.concatenate([hi, np.zeros((pad, 3), np.int64)])
        real_p = np.concatenate([real, np.zeros(pad, bool)])
        lo_g = lo_p.reshape(size, degree, 3)
        hi_g = hi_p.reshape(size, degree, 3)
        real_g = real_p.reshape(size, degree)
        big = np.int64(1) << 60
        plo = np.where(real_g[:, :, None], lo_g, big).min(axis=1)
        phi = np.where(real_g[:, :, None], hi_g, -big).max(axis=1)
        any_real = real_g.any(axis=1)
        plo = np.where(any_real[:, None], plo, 0)
        phi = np.where(any_real[:, None], phi, 0)
        # parents always keep their child run, even over dummy-only
        # groups (zero-extent boxes are never entered); a nchild of 0
        # would read as a leaf for triangle 0
        nch = np.minimum(degree,
                         cnt - degree * np.arange(size)).astype(np.uint32)
        first = (child_abs + degree * np.arange(size)).astype(np.uint32)
        layers.append(pack_nodes(plo, phi, first, nch))
        lo, hi, real = plo, phi, any_real
        child_abs -= size

    layers.reverse()                         # root first
    new_nodes = np.concatenate(layers + [kept])
    return BVH(bvh.world_coords, new_nodes,
               np.cumsum([0] + sizes).tolist()
               + [new_base + b - old_base
                  for b in lb[layer_idx + 1:-1]])


def optimize_layer(nodes, max_sweeps=1, window=32):
    """Greedy surface-area minimization of sibling pairings within a layer
    (a bounded numpy version of the reference's iterative pair-swap search,
    reference: chroma/gpu/bvh.py:269-369, cuda/bvh.cu:402-528): for each
    even slot, pick the partner among the next `window` nodes that
    minimizes the union area of the pair."""
    from chroma_tpu_torch.bvh.bvh import unpack_nodes

    nodes = nodes.copy()
    u = unpack_nodes(nodes)
    lo = np.stack([u['xlo'], u['ylo'], u['zlo']], axis=1).astype(np.int64)
    hi = np.stack([u['xhi'], u['yhi'], u['zhi']], axis=1).astype(np.int64)

    def pair_area(i, j):
        l = np.minimum(lo[i], lo[j])
        h = np.maximum(hi[i], hi[j])
        d = h - l
        return 2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    n = len(nodes)
    for _ in range(max_sweeps):
        swaps = 0
        for i in range(0, n - 1, 2):
            best_j = i + 1
            best_area = pair_area(i, i + 1)
            for j in range(i + 2, min(i + 2 + window, n)):
                a = pair_area(i, j)
                if a < best_area:
                    best_area = a
                    best_j = j
            if best_j != i + 1:
                nodes[[i + 1, best_j]] = nodes[[best_j, i + 1]]
                lo[[i + 1, best_j]] = lo[[best_j, i + 1]]
                hi[[i + 1, best_j]] = hi[[best_j, i + 1]]
                swaps += 1
        if swaps == 0:
            break
    return nodes
