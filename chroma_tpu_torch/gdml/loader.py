"""GDML detector import by direct XML parsing
(reference: chroma/gdml/loader.py).

A subset of GDML is supported; unsupported features raise. Unlike the
reference, primitive solids are tessellated in pure numpy
(chroma_tpu_torch.gdml.mesh_gen) instead of through gmsh/OpenCASCADE, so no CAD
stack is needed. CSG boolean solids are meshed through gmsh only when it
is importable; otherwise they raise NotImplementedError.
"""
from __future__ import annotations

import xml.etree.ElementTree as et
from collections import deque
from copy import deepcopy

import numpy as np

from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.transform import make_rotation_matrix
from chroma_tpu_torch.geometry import Mesh, Solid
from chroma_tpu_torch.gdml import mesh_gen

# unit scales to mm / radians
units = {'cm': 10, 'mm': 1, 'm': 1000, 'um': 1e-3, 'nm': 1e-6,
         'deg': np.pi / 180, 'rad': 1}


class Volume(object):
    """A GDML logical volume and its placed children, with per-placement
    position/rotation."""

    def __init__(self, name, gdml):
        self.name = name
        elem = gdml.vol_map[name]
        self.material_ref = elem.find('materialref').get('ref')
        self.solid_ref = elem.find('solidref').get('ref')
        self.children = []
        self.child_pos = []
        self.child_rot = []
        for placement in elem.findall('physvol'):
            vol = Volume(placement.find('volumeref').get('ref'), gdml)
            pos, rot = gdml.get_pos_rot(placement)
            self.children.append(vol)
            self.child_pos.append(pos)
            self.child_rot.append(rot)

    def show_hierarchy(self, indent=''):
        print(indent + str(self), self.solid_ref, self.material_ref)
        for child in self.children:
            child.show_hierarchy(indent=indent + ' ')

    def __str__(self):
        return self.name

    __repr__ = __str__


def _default_volume_classifier(volume_ref, material_ref,
                               parent_material_ref):
    "Example classifier, primarily for visualization."
    from chroma_tpu_torch.demo.optics import vacuum
    if 'OpDetSensitive' in volume_ref:
        return 'pmt', dict(material1=vacuum, material2=vacuum,
                           color=0xA0A05000, surface=None, channel_type=0)
    elif material_ref == parent_material_ref:
        return 'omit', dict()
    return 'solid', dict(material1=vacuum, material2=vacuum,
                         color=0xEEA0A0A0, surface=None)


class GDMLLoader(object):
    """Load a geometry from a GDML file by direct XML parsing."""

    def __init__(self, gdml_file, nsteps=mesh_gen.DEFAULT_NSTEPS):
        self.gdml_file = gdml_file
        self.nsteps = nsteps
        xml = et.parse(gdml_file)
        gdml = xml.getroot()

        define = gdml.find('define')
        self.pos_map = {p.get('name'): p
                        for p in define.findall('position')} \
            if define is not None else {}
        self.rot_map = {r.get('name'): r
                        for r in define.findall('rotation')} \
            if define is not None else {}

        self.solid_map = {s.get('name'): s for s in gdml.find('solids')}
        structure = gdml.find('structure')
        self.vol_map = {v.get('name'): v
                        for v in structure.findall('volume')}
        world_ref = gdml.find('setup').find('world').get('ref')
        self.world = Volume(world_ref, self)
        self.mesh_cache = {}

    # --- XML helpers -----------------------------------------------------

    def get_pos_rot(self, elem, refs=('position', 'rotation')):
        "Inline or referenced <position>/<rotation> children (or None)."
        pos_ref, rot_ref = refs
        pos = elem.find(pos_ref)
        if pos is None:
            ref = elem.find(pos_ref + 'ref')
            if ref is not None:
                pos = self.pos_map[ref.get('ref')]
        rot = elem.find(rot_ref)
        if rot is None:
            ref = elem.find(rot_ref + 'ref')
            if ref is not None:
                rot = self.rot_map[ref.get('ref')]
        return pos, rot

    def get_val(self, elem, attr, default=None):
        txt = elem.get(attr, default=None)
        assert txt is not None or default is not None, \
            'Missing attribute: ' + attr
        return eval(txt, {}, {}) if txt is not None else default

    def get_vals(self, elem, value_attr=('x', 'y', 'z'),
                 unit_attr='unit', default=0.0):
        scale = units[elem.get(unit_attr)] \
            if unit_attr is not None and elem.get(unit_attr) else 1.0
        return np.array([self.get_val(elem, a, default) * scale
                         for a in value_attr])

    def _lunit(self, elem):
        return units.get(elem.get('lunit', 'mm'), 1.0)

    def _aunit(self, elem):
        return units.get(elem.get('aunit', 'rad'), 1.0)

    # --- solid meshing ---------------------------------------------------

    def get_mesh(self, solid_ref):
        "Tessellate (and cache) the named solid."
        if solid_ref in self.mesh_cache:
            return self.mesh_cache[solid_ref]

        elem = self.solid_map[solid_ref]
        tag = elem.tag
        lu = self._lunit(elem)
        au = self._aunit(elem)
        g = lambda a, d=None: self.get_val(elem, a, d)  # noqa: E731

        if tag in ('union', 'subtraction', 'intersection'):
            mesh = self._boolean_mesh(elem, tag)
        elif tag == 'box':
            mesh = mesh_gen.box(g('x') * lu, g('y') * lu, g('z') * lu)
        elif tag == 'tube':
            mesh = mesh_gen.tube(g('rmin', 0.0) * lu, g('rmax') * lu,
                                 g('z') * lu, g('startphi', 0.0) * au,
                                 g('deltaphi', 2 * np.pi) * au,
                                 nsteps=self.nsteps)
        elif tag == 'eltube':
            mesh = mesh_gen.eltube(g('dx') * lu, g('dy') * lu,
                                   g('dz') * lu, nsteps=self.nsteps)
        elif tag == 'orb':
            mesh = mesh_gen.orb(g('r') * lu, nsteps=self.nsteps)
        elif tag == 'sphere':
            mesh = mesh_gen.sphere(g('rmin', 0.0) * lu, g('rmax') * lu,
                                   g('startphi', 0.0) * au,
                                   g('deltaphi', 2 * np.pi) * au,
                                   g('starttheta', 0.0) * au,
                                   g('deltatheta', np.pi) * au,
                                   nsteps=self.nsteps)
        elif tag == 'polycone':
            zplanes = [(self.get_val(zp, 'rmin', 0.0) * lu,
                        self.get_val(zp, 'rmax') * lu,
                        self.get_val(zp, 'z') * lu)
                       for zp in elem.findall('zplane')]
            mesh = mesh_gen.polycone(g('startphi', 0.0) * au,
                                     g('deltaphi', 2 * np.pi) * au,
                                     zplanes, nsteps=self.nsteps)
        elif tag == 'polyhedra':
            zplanes = [(self.get_val(zp, 'rmin', 0.0) * lu,
                        self.get_val(zp, 'rmax') * lu,
                        self.get_val(zp, 'z') * lu)
                       for zp in elem.findall('zplane')]
            mesh = mesh_gen.polyhedra(g('startphi', 0.0) * au,
                                      g('deltaphi', 2 * np.pi) * au,
                                      int(g('numsides')), zplanes)
        elif tag == 'torus':
            mesh = mesh_gen.torus(g('rmin', 0.0) * lu, g('rmax') * lu,
                                  g('rtor') * lu, g('startphi', 0.0) * au,
                                  g('deltaphi', 2 * np.pi) * au,
                                  nsteps=self.nsteps)
        elif tag == 'trd':
            mesh = mesh_gen.trd(g('x1') * lu / 2, g('x2') * lu / 2,
                                g('y1') * lu / 2, g('y2') * lu / 2,
                                g('z') * lu / 2)
        elif tag == 'opticalsurface':
            mesh = None
        else:
            raise NotImplementedError('GDML solid type %r not supported'
                                      % tag)

        self.mesh_cache[solid_ref] = mesh
        return mesh

    def _boolean_mesh(self, elem, op):
        """CSG boolean solid: mesh both operands and combine with the BSP
        engine (chroma_tpu_torch.csg). The <position>/<rotation> children (or
        their refs) place the SECOND solid in the first solid's frame,
        with the same frame-rotation convention as physvol placement
        (reference: chroma/gdml/gen_mesh.py gdml_boolean, which does the
        same through OpenCASCADE)."""
        from chroma_tpu_torch.csg import mesh_boolean
        first = self.get_mesh(elem.find('first').get('ref'))
        second = self.get_mesh(elem.find('second').get('ref'))

        pos, rot = self.get_pos_rot(elem)
        c_pos = self.get_vals(pos) if pos is not None else np.zeros(3)
        c_ang = self.get_vals(rot) if rot is not None else np.zeros(3)
        x_rot = make_rotation_matrix(c_ang[0], [1, 0, 0])
        y_rot = make_rotation_matrix(c_ang[1], [0, 1, 0])
        z_rot = make_rotation_matrix(c_ang[2], [0, 0, 1])
        rmat = x_rot @ y_rot @ z_rot

        moved = Mesh((second.vertices @ rmat.T) + c_pos,
                     second.triangles, round=False)
        return mesh_boolean(op, first, moved)

    # --- detector construction -------------------------------------------

    def build_detector(self, detector=None,
                       volume_classifier=_default_volume_classifier,
                       solidsToIgnore=None):
        """Walk the volume tree and place each volume's mesh into a
        Detector. volume_classifier(volume_ref, material_ref,
        parent_material_ref) -> ('pmt'|'solid'|'omit', solid_kwargs)."""
        from chroma_tpu_torch.demo.optics import vacuum
        if detector is None:
            detector = Detector(vacuum)
        ignore = solidsToIgnore or (lambda _: False)

        q = deque()
        q.append([self.world, np.zeros(3), np.identity(3), None])
        while q:
            v, pos, rot, parent_material_ref = q.pop()
            for child, c_pos, c_rot in zip(v.children, v.child_pos,
                                           v.child_rot):
                c_pos = self.get_vals(c_pos) if c_pos is not None \
                    else np.zeros(3)
                c_ang = self.get_vals(c_rot) if c_rot is not None \
                    else np.zeros(3)
                c_pos = (rot @ c_pos) + pos
                x_rot = make_rotation_matrix(c_ang[0], [1, 0, 0])
                y_rot = make_rotation_matrix(c_ang[1], [0, 1, 0])
                z_rot = make_rotation_matrix(c_ang[2], [0, 0, 1])
                q.append([child, c_pos, rot @ x_rot @ y_rot @ z_rot,
                          v.material_ref])

            classification, kwargs = volume_classifier(
                v.name, v.material_ref, parent_material_ref)
            if classification == 'omit' or ignore(v.solid_ref):
                continue

            mesh = self.get_mesh(v.solid_ref)
            if mesh is None:
                continue
            mesh = deepcopy(mesh)

            if classification == 'pmt':
                channel_type = kwargs.pop('channel_type', None)
                detector.add_pmt(Solid(mesh, **kwargs), displacement=pos,
                                 rotation=rot, channel_type=channel_type)
            elif classification == 'solid':
                detector.add_solid(Solid(mesh, **kwargs),
                                   displacement=pos, rotation=rot)
            else:
                raise Exception('Unknown volume classification: '
                                + classification)
        return detector
