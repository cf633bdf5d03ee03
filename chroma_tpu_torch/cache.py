"""On-disk geometry and BVH cache of the torch port (the port's copy of
chroma_tpu.cache; reference: chroma/cache.py).

Geometries are stored by name; BVHs are stored under the MD5 hash of the
flattened mesh so they invalidate automatically when the geometry changes.
The default cache lives in ~/.chroma_tpu_torch (override with
CHROMA_CACHE_DIR). Not safe against concurrent writers.
"""
from __future__ import annotations

import copy
import os
import pickle

from chroma_tpu_torch.log import logger

cache_dir = os.environ.get('CHROMA_CACHE_DIR',
                           os.path.expanduser('~/.chroma_tpu_torch/'))


class GeometryNotFoundError(Exception):
    """A requested geometry was not found in the on-disk cache."""


class BVHNotFoundError(Exception):
    """A requested BVH was not found in the on-disk cache."""


def verify_or_create_dir(dirname, exception_msg, logger_msg=None):
    """Create `dirname` if missing; raise IOError if it exists but is not
    a directory."""
    if not os.path.isdir(dirname):
        if os.path.exists(dirname):
            raise IOError(exception_msg)
        if logger_msg is not None:
            logger.info(logger_msg)
        os.makedirs(dirname, exist_ok=True)


class Cache(object):
    """Disk cache directory with 'geo/<name>' and 'bvh/<mesh_md5>/<name>'
    pickle stores. Geometry and BVH names must be filesystem-safe
    identifiers; the name maps directly to a filename.

    A cache belongs to one package: a pickle stores the class paths of
    what it holds, so a geometry or BVH pickled by chroma_tpu is not the
    port's (it would unpickle into chroma_tpu's classes), and one pickled
    here does not load in chroma_tpu. Keep each package's cache in its own
    directory; the device-ready geocache (chroma_tpu_torch.io.geocache)
    is the format the two packages share."""

    def __init__(self, cache_dir=cache_dir):
        self.cache_dir = cache_dir
        verify_or_create_dir(
            self.cache_dir,
            exception_msg='Path for cache already exists, but is not a '
                          'directory: %s' % cache_dir,
            logger_msg='Creating new cache directory at %s' % cache_dir)

        self.geo_dir = os.path.join(cache_dir, 'geo')
        verify_or_create_dir(
            self.geo_dir,
            exception_msg='Path for geometry directory in cache already '
                          'exists, but is not a directory: %s' % self.geo_dir)

        self.bvh_dir = os.path.join(cache_dir, 'bvh')
        verify_or_create_dir(
            self.bvh_dir,
            exception_msg='Path for BVH directory in cache already exists, '
                          'but is not a directory: %s' % self.bvh_dir)

    # --- geometries ---

    def get_geometry_filename(self, name):
        return os.path.join(self.geo_dir, name)

    def list_geometry(self):
        return os.listdir(self.geo_dir)

    def save_geometry(self, name, geometry):
        """Pickle `geometry` (minus its BVH and un-flattened solids) under
        `name`, prefixed by the mesh hash for fast lookups."""
        geo_file = self.get_geometry_filename(name)
        reduced = copy.copy(geometry)
        reduced.bvh = None
        reduced.solids = []
        reduced.solid_rotations = []
        reduced.solid_displacements = []
        with open(geo_file, 'wb') as f:
            pickle.dump(geometry.mesh.md5(), f, pickle.HIGHEST_PROTOCOL)
            pickle.dump(reduced, f, pickle.HIGHEST_PROTOCOL)

    def load_geometry(self, name):
        geo_file = self.get_geometry_filename(name)
        if not os.path.exists(geo_file):
            raise GeometryNotFoundError(name)
        with open(geo_file, 'rb') as f:
            pickle.load(f)  # skip mesh hash
            return pickle.load(f)

    def remove_geometry(self, name):
        geo_file = self.get_geometry_filename(name)
        if os.path.exists(geo_file):
            os.remove(geo_file)

    def get_geometry_hash(self, name):
        "Mesh hash for `name` without unpickling the whole geometry."
        geo_file = self.get_geometry_filename(name)
        if not os.path.exists(geo_file):
            raise GeometryNotFoundError(name)
        with open(geo_file, 'rb') as f:
            return pickle.load(f)

    def load_default_geometry(self):
        return self.load_geometry('.default')

    def set_default_geometry(self, name):
        "Symlink `.default` to the named geometry."
        default_geo_file = self.get_geometry_filename('.default')
        geo_file = self.get_geometry_filename(name)
        if not os.path.exists(geo_file):
            raise GeometryNotFoundError(name)
        # lexists: a dangling symlink (target removed) must still be
        # replaced, and os.path.exists would miss it
        if os.path.lexists(default_geo_file):
            if os.path.islink(default_geo_file):
                os.remove(default_geo_file)
            else:
                raise IOError('Non-symlink found where expected a symlink: '
                              + default_geo_file)
        os.symlink(geo_file, default_geo_file)

    # --- BVHs ---

    def get_bvh_directory(self, mesh_hash):
        return os.path.join(self.bvh_dir, mesh_hash)

    def get_bvh_filename(self, mesh_hash, name='default'):
        return os.path.join(self.get_bvh_directory(mesh_hash), name)

    def list_bvh(self, mesh_hash):
        bvh_dir = self.get_bvh_directory(mesh_hash)
        return os.listdir(bvh_dir) if os.path.isdir(bvh_dir) else []

    def exist_bvh(self, mesh_hash, name='default'):
        return os.path.isfile(self.get_bvh_filename(mesh_hash, name))

    def save_bvh(self, bvh, mesh_hash, name='default'):
        bvh_dir = self.get_bvh_directory(mesh_hash)
        verify_or_create_dir(bvh_dir,
                             exception_msg='Non-directory already exists '
                             'where BVH directory should go: ' + bvh_dir)
        with open(self.get_bvh_filename(mesh_hash, name), 'wb') as f:
            pickle.dump(bvh, f, pickle.HIGHEST_PROTOCOL)

    def load_bvh(self, mesh_hash, name='default'):
        bvh_file = self.get_bvh_filename(mesh_hash, name)
        if not os.path.exists(bvh_file):
            raise BVHNotFoundError(mesh_hash + ':' + name)
        with open(bvh_file, 'rb') as f:
            return pickle.load(f)

    def remove_bvh(self, mesh_hash, name='default'):
        bvh_file = self.get_bvh_filename(mesh_hash, name)
        if os.path.exists(bvh_file):
            os.remove(bvh_file)
