"""BVH traversal: stackless escape-pointer walk, lockstep over the batch
(counterpart of chroma_tpu.ops.mesh), in plain PyTorch.

The reference traverses with a per-thread explicit stack
(reference: chroma/cuda/mesh.h:45-126). Here every ray carries a single
node index into a DFS-ordered node array (chroma_tpu_torch.bvh.dfs):

    hit internal node -> descend to idx+1 (first child is adjacent)
    miss, or leaf     -> jump to escape[idx] (skip the subtree)

Nearest-hit pruning (skip boxes farther than the best triangle so far) and
the "can't hit the same triangle twice in a row" rule match the reference.

This walk is on no path of the simulation or the renderer, which query the
instanced wide BVH (ops.visit_kernel.traverse). It reads the classic
layered BVH instead, through `build_dfs_arrays`, and shares no table and
no code with the wide walk: an independent reference for it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chroma_tpu_torch.bvh.dfs import flatten_to_dfs
from chroma_tpu_torch.ops import visit_kernel
from chroma_tpu_torch.ops.intersect import intersect_box, intersect_triangle
from chroma_tpu_torch.ops.linalg import normalize

CHILD_BITS = 28
CHILD_MASK = (1 << CHILD_BITS) - 1


@dataclasses.dataclass
class DFSArrays:
    """The classic BVH of a geometry in DFS preorder with escape links,
    and the triangle soup its leaves index."""
    nodes: torch.Tensor         # (M,4) i32 (u32 bit patterns)
    escape: torch.Tensor        # (M,) i32
    world_origin: torch.Tensor  # (3,) f32
    world_scale: torch.Tensor   # () f32
    vertices: torch.Tensor      # (V,3) f32
    triangles: torch.Tensor     # (T,3) i32
    n_nodes: int

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != 'n_nodes'})


def build_dfs_arrays(geometry):
    """DFSArrays (CPU tensors) of a flattened host geometry with a classic
    BVH attached (`geometry.bvh`), re-laid by flatten_to_dfs."""
    dfs_nodes, escape = flatten_to_dfs(geometry.bvh)
    coords = geometry.bvh.world_coords
    return DFSArrays(
        nodes=torch.from_numpy(dfs_nodes.view(np.int32).copy()),
        escape=torch.from_numpy(np.ascontiguousarray(escape, np.int32)),
        world_origin=torch.tensor(np.asarray(coords.world_origin,
                                             np.float32)),
        world_scale=torch.tensor(np.float32(coords.world_scale)),
        vertices=torch.from_numpy(
            np.ascontiguousarray(geometry.mesh.vertices, np.float32)),
        triangles=torch.from_numpy(
            np.ascontiguousarray(geometry.mesh.triangles, np.int32)),
        n_nodes=len(dfs_nodes))


def decode_bounds(node_xyz, world_origin, world_scale):
    """Unpack 16-bit fixed-point AABB words (reference:
    chroma/cuda/geometry.h:28-45). node_xyz: (...,3) int32 holding the u32
    words."""
    lo = (node_xyz & 0xFFFF).to(torch.float32)
    hi = ((node_xyz >> 16) & 0xFFFF).to(torch.float32)
    return (world_origin + lo * world_scale,
            world_origin + hi * world_scale)


def intersect_mesh(origin, direction, dfs, last_hit_triangle=None,
                   mask=None):
    """Nearest triangle intersection for a batch of rays.

    origin/direction: (N,3) f32 (direction normalized); dfs: DFSArrays on
    their device. last_hit_triangle: (N,) i32 or None; that triangle is
    excluded (a photon can't hit the triangle it is sitting on).
    mask: (N,) bool or None; lanes outside the mask skip traversal.

    Returns (triangle (N,) i32, -1 for no hit; distance (N,) f32, +inf
    for no hit).
    """
    n = origin.shape[0]
    dev = origin.device
    m = dfs.n_nodes
    if last_hit_triangle is None:
        last_hit_triangle = torch.full((n,), -1, dtype=torch.int32,
                                       device=dev)

    inv_dir = 1.0 / direction
    neg_origin_inv_dir = -origin * inv_dir

    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    if mask is not None:
        cur = torch.where(mask, cur, m)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_d = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)

    while True:
        a = torch.nonzero(cur < m)[:, 0]
        if a.numel() == 0:
            break
        c, o, d = cur[a], origin[a], direction[a]
        node = dfs.nodes[c]  # (A,4) gather
        lower, upper = decode_bounds(node[:, :3], dfs.world_origin,
                                     dfs.world_scale)
        box_hit, box_d = intersect_box(o, neg_origin_inv_dir[a], inv_dir[a],
                                       lower, upper)
        # nearest-hit pruning (reference: mesh.h:16-38)
        hit = box_hit & (box_d <= best_d[a])

        w = node[:, 3]
        nchild = (w >> CHILD_BITS) & 0xF
        tri_id = w & CHILD_MASK
        is_leaf = nchild == 0

        leaf_test = hit & is_leaf & (tri_id != last_hit_triangle[a])
        tri = dfs.triangles[torch.where(leaf_test, tri_id, 0).to(
            torch.int64)].to(torch.int64)
        tri_hit, t = intersect_triangle(o, d, dfs.vertices[tri[:, 0]],
                                        dfs.vertices[tri[:, 1]],
                                        dfs.vertices[tri[:, 2]])

        closer = leaf_test & tri_hit & (t < best_d[a])
        best_d[a] = torch.where(closer, t, best_d[a])
        best_tri[a] = torch.where(closer, tri_id, best_tri[a])

        descend = hit & ~is_leaf
        cur[a] = torch.where(descend, c + 1, dfs.escape[c].to(torch.int64))
    return best_tri, best_d


def distance_to_mesh(origin, direction, geometry):
    """Distance from each ray origin to the mesh, +inf for no hit (device
    analog of the distance_to_mesh kernel, reference:
    chroma/cuda/mesh.h:131-159). `geometry` is the port's GeometryArrays:
    the query takes the wide walk, as every geometry does."""
    direction = normalize(direction.to(torch.float32)).contiguous()
    tri, dist, _, _, _, _ = visit_kernel.traverse(
        geometry.wide, origin.to(torch.float32).contiguous(), direction)
    return torch.where(tri >= 0, dist, torch.inf)
