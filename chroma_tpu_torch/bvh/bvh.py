"""Bounding volume hierarchy: packed node format and containers (the torch
port's copy of chroma_tpu.bvh.bvh, host numpy).

The node format is bit-compatible with the reference
(reference: chroma/bvh/bvh.py, chroma/cuda/geometry_types.h:86-96):

  Each node is four uint32 words (x, y, z, w).  x/y/z hold the AABB in
  16-bit unsigned fixed point world coordinates: low half = lower bound,
  high half = upper bound.  w packs the child pointer in the low 28 bits
  and the child count in the top 4 bits; nchild == 0 marks a leaf whose
  "child" is a triangle index.

Keeping the format identical makes BVH caches portable between frameworks
and lets the reference's node-level tests run unchanged.
"""
from __future__ import annotations

import numpy as np

CHILD_BITS = 28
NCHILD_MASK = np.uint64(0xFFFF << CHILD_BITS)

# numpy structured dtype standing in for CUDA's uint4
uint4 = np.dtype([('x', np.uint32), ('y', np.uint32),
                  ('z', np.uint32), ('w', np.uint32)])


def empty_nodes(n):
    return np.zeros(n, dtype=uint4)


def pack_nodes(lower, upper, child, nchild):
    """Pack fixed-point bounds (n,3) uint16-range ints, child pointers and
    child counts into the uint4 node format."""
    nodes = np.empty(len(child), dtype=uint4)
    lower = np.asarray(lower, dtype=np.uint32)
    upper = np.asarray(upper, dtype=np.uint32)
    for i, axis in enumerate('xyz'):
        nodes[axis] = lower[:, i] | (upper[:, i] << 16)
    nodes['w'] = (np.asarray(nchild, dtype=np.uint32) << CHILD_BITS) \
        | np.asarray(child, dtype=np.uint32)
    return nodes


def unpack_nodes(nodes):
    """Unpack a uint4 node array into a record array with fields
    xlo/xhi/ylo/yhi/zlo/zhi/child/nchild."""
    unpacked_dtype = np.dtype([('xlo', np.uint16), ('xhi', np.uint16),
                               ('ylo', np.uint16), ('yhi', np.uint16),
                               ('zlo', np.uint16), ('zhi', np.uint16),
                               ('child', np.uint64), ('nchild', np.uint16)])
    unpacked = np.empty(shape=len(nodes), dtype=unpacked_dtype)
    for axis in 'xyz':
        unpacked[axis + 'lo'] = nodes[axis] & 0xFFFF
        unpacked[axis + 'hi'] = nodes[axis] >> 16
    unpacked['child'] = nodes['w'].astype(np.uint64) & ~NCHILD_MASK
    unpacked['nchild'] = nodes['w'] >> CHILD_BITS
    return unpacked


class OutOfRangeError(Exception):
    """World coordinates exceed the range of unsigned 16-bit fixed point."""


class WorldCoords(object):
    """Transformation between floating point world coordinates and unsigned
    16-bit fixed point: world = world_scale * fixed + world_origin."""

    MAX_INT = 2 ** 16 - 1

    def __init__(self, world_origin, world_scale):
        self.world_origin = np.array(world_origin, dtype=np.float32)
        self.world_scale = np.float32(world_scale)

    def world_to_fixed(self, world):
        "Convert world vectors to fixed point (rounds to nearest)."
        fixed = ((np.asarray(world, dtype=np.float64) - self.world_origin)
                 / self.world_scale).round()
        if int(fixed.max()) > WorldCoords.MAX_INT or fixed.min() < 0:
            raise OutOfRangeError('range = (%f, %f)'
                                  % (fixed.min(), fixed.max()))
        return fixed.astype(np.uint16)

    def fixed_to_world(self, fixed):
        "Convert fixed-point vectors to world coordinates."
        return np.asarray(fixed) * self.world_scale + self.world_origin


def node_areas(nodes):
    "Surface area of each node's AABB in fixed-point units."
    unpacked = unpack_nodes(nodes)
    dx = (unpacked['xhi'] - unpacked['xlo']).astype(float)
    dy = (unpacked['yhi'] - unpacked['ylo']).astype(float)
    dz = (unpacked['zhi'] - unpacked['zlo']).astype(float)
    return 2.0 * (dx * dy + dy * dz + dz * dx)


class BVH(object):
    """A layered BVH over a triangle mesh.

    Nodes are stored root-first in one packed array; each layer of the tree
    is a contiguous slice recorded in `layer_offsets`. Inner nodes point at
    a contiguous run of children in a deeper layer. Dummy zero-area nodes
    pad layers and must be ignored.
    """

    def __init__(self, world_coords, nodes, layer_offsets):
        self.world_coords = world_coords
        self.nodes = nodes
        self.layer_offsets = list(layer_offsets)
        self.layer_bounds = list(layer_offsets) + [len(nodes)]

    def get_layer(self, layer_number):
        "BVHLayerSlice for the given layer (root = layer 0)."
        layer_slice = slice(self.layer_bounds[layer_number],
                            self.layer_bounds[layer_number + 1])
        return BVHLayerSlice(world_coords=self.world_coords,
                             nodes=self.nodes[layer_slice])

    def layer_count(self):
        return len(self.layer_offsets)

    def __len__(self):
        return len(self.nodes)


class BVHLayerSlice(object):
    """View of one BVH layer (shares node storage with the parent BVH)."""

    def __init__(self, world_coords, nodes):
        self.world_coords = world_coords
        self.nodes = nodes

    def __len__(self):
        return len(self.nodes)

    def areas_fixed(self):
        return node_areas(self.nodes)

    def area_fixed(self):
        return node_areas(self.nodes).sum()

    def area(self):
        "Total surface area of this layer in world units."
        return self.area_fixed().sum() * self.world_coords.world_scale ** 2

    def get_bounds(self):
        "Lower/upper world-coordinate bounds of each node in this layer."
        node_info = unpack_nodes(self.nodes)
        fixed_lower = np.dstack([node_info[s]
                                 for s in ['xlo', 'ylo', 'zlo']]).squeeze()
        fixed_upper = np.dstack([node_info[s]
                                 for s in ['xhi', 'yhi', 'zhi']]).squeeze()
        lower = self.world_coords.fixed_to_world(fixed_lower)
        upper = self.world_coords.fixed_to_world(fixed_upper)
        return np.atleast_2d(lower), np.atleast_2d(upper)
