"""Geometry-string resolver and BVH load-or-build convenience layer of the
torch port (the port's copy of chroma_tpu.loader; reference:
chroma/loader.py). No device is needed: the BVH builder here is pure
numpy, and the classic BVH it attaches is host-side only (the port's
device path builds the instanced wide table from the solids). `@pkg.obj`
descriptors resolve in the port, e.g. @chroma_tpu_torch.demo.tiny."""
from __future__ import annotations

import os
import sys
import time

from chroma_tpu_torch.log import logger
from chroma_tpu_torch.cache import Cache
from chroma_tpu_torch.bvh import make_recursive_grid_bvh
from chroma_tpu_torch.geometry import Geometry, Solid, Mesh, vacuum
from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.stl import mesh_from_stl


def load_geometry_from_string(geometry_str, auto_build_bvh=True,
                              read_bvh_cache=True, update_bvh_cache=True,
                              cache_dir=None):
    """Create or load a geometry (and its BVH) from a descriptor string:

      ""                       - default cached geometry + default BVH
      "file.stl[.bz2]"         - geometry from a mesh file on disk
      "name"                   - cached geometry by name, default BVH
      "name:bvh"               - cached geometry + named BVH
      "@pkg.module.obj[:bvh]"  - geometry built by a Python object/callable

    Returns a Geometry (or subclass) with .bvh set when options allow.
    """
    bvh_name = 'default'
    if ':' in geometry_str:
        geometry_id, bvh_name = geometry_str.split(':')
    else:
        geometry_id = geometry_str

    cache = Cache() if cache_dir is None else Cache(cache_dir)

    if os.path.exists(geometry_id) and \
            geometry_id.lower().endswith(('.stl', '.bz2')):
        mesh = mesh_from_stl(geometry_id)
        geometry = Geometry()
        geometry.add_solid(Solid(mesh, vacuum, vacuum, color=0x33ffffff))
        geometry.flatten()

    elif geometry_id.startswith('@'):
        function_path = geometry_id[1:]
        module_name, obj_name = function_path.rsplit('.', 1)
        orig_sys_path = list(sys.path)
        try:
            sys.path.append('.')
            module = __import__(module_name, fromlist=[obj_name])
        finally:
            sys.path = orig_sys_path
        obj = getattr(module, obj_name)
        return create_geometry_from_obj(
            obj, bvh_name=bvh_name, auto_build_bvh=auto_build_bvh,
            read_bvh_cache=read_bvh_cache, update_bvh_cache=update_bvh_cache,
            cache_dir=cache_dir)

    else:
        if geometry_id == '':
            geometry = cache.load_default_geometry()
        else:
            geometry = cache.load_geometry(geometry_id)
        # cached geometries are flattened already

    geometry.bvh = load_bvh(geometry, bvh_name=bvh_name,
                            auto_build_bvh=auto_build_bvh,
                            read_bvh_cache=read_bvh_cache,
                            update_bvh_cache=update_bvh_cache,
                            cache_dir=cache_dir)
    return geometry


def load_bvh(geometry, bvh_name='default', auto_build_bvh=True,
             read_bvh_cache=True, update_bvh_cache=True, cache_dir=None):
    "Load a cached BVH for `geometry`, or build (and cache) one."
    cache = Cache() if cache_dir is None else Cache(cache_dir)

    mesh_hash = geometry.mesh.md5()
    bvh = None
    if read_bvh_cache and cache.exist_bvh(mesh_hash, bvh_name):
        logger.info('Loading BVH "%s" for geometry from cache.' % bvh_name)
        bvh = cache.load_bvh(mesh_hash, bvh_name)
    elif auto_build_bvh:
        logger.info('Building new BVH using recursive grid algorithm.')
        start = time.time()
        bvh = make_recursive_grid_bvh(geometry.mesh, target_degree=3)
        logger.info('BVH generated in %1.1f seconds.' % (time.time() - start))
        if update_bvh_cache:
            logger.info('Saving BVH (%s:%s) to cache.' % (mesh_hash, bvh_name))
            cache.save_bvh(bvh, mesh_hash, bvh_name)
    return bvh


def as_flat_geometry(obj):
    """Wrap a Detector/Geometry/Solid/Mesh (or a callable returning one) in
    a flattened Geometry; its BVH is left as it was."""
    if callable(obj):
        obj = obj()

    if isinstance(obj, (Detector, Geometry)):
        geometry = obj
    elif isinstance(obj, Solid):
        geometry = Geometry()
        geometry.add_solid(obj)
    elif isinstance(obj, Mesh):
        geometry = Geometry()
        geometry.add_solid(Solid(obj, vacuum, vacuum, color=0x33ffffff))
    else:
        raise TypeError('cannot build type %s' % type(obj))

    geometry.flatten()
    return geometry


def create_geometry_from_obj(obj, bvh_name='default', auto_build_bvh=True,
                             read_bvh_cache=True, update_bvh_cache=True,
                             cache_dir=None):
    """Wrap a Detector/Geometry/Solid/Mesh (or a callable returning one) in
    a flattened Geometry with a BVH attached."""
    geometry = as_flat_geometry(obj)
    if geometry.bvh is None:
        geometry.bvh = load_bvh(geometry, bvh_name=bvh_name,
                                auto_build_bvh=auto_build_bvh,
                                read_bvh_cache=read_bvh_cache,
                                update_bvh_cache=update_bvh_cache,
                                cache_dir=cache_dir)
    return geometry
