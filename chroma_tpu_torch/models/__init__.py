"""Demo meshes (reference: chroma/models/).

Any .stl / .stl.bz2 file placed in this directory becomes a loadable
attribute (usable as "@chroma_tpu_torch.models.<name>" geometry strings).
Ships the same public demo mesh assets as the reference (companioncube,
liberty, lionsolid, MiniFig, tie_interceptor6 — data files, not code)
plus a few procedural extras."""
import glob
import os.path
import sys


class Loader(object):
    def __init__(self, filename):
        self.filename = filename

    def __call__(self):
        from chroma_tpu_torch.stl import mesh_from_stl
        return mesh_from_stl(self.filename)


_this_module = sys.modules[__name__]
for _filename in glob.glob(os.path.join(os.path.dirname(__file__),
                                        '*.stl*')):
    _name = os.path.basename(_filename)
    while os.path.splitext(_name)[1]:
        _name = os.path.splitext(_name)[0]
    setattr(_this_module, _name, Loader(_filename))


# procedural stand-ins for the reference's binary demo meshes
def icosahedron():
    from chroma_tpu_torch.make import sphere
    return sphere(100.0, nsteps=8)


def ball():
    from chroma_tpu_torch.make import sphere
    return sphere(100.0, nsteps=64)


def donut():
    from chroma_tpu_torch.make import torus
    return torus(30.0, 100.0, nsteps=48)
