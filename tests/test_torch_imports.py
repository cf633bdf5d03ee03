"""The port stands on its own: no module of chroma_tpu_torch, and not
chip_smoke.py, imports the JAX package chroma_tpu, jax, jaxlib or flax --
at its top, inside a function or in a try block alike -- and the port
reads its data files and sources from its own directory. Each file is
parsed with ast, not imported, so this holds on any machine. Importing the
package and its host-only tools starts no device library."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'chroma_tpu_torch')
FORBIDDEN = ('chroma_tpu', 'jax', 'jaxlib', 'flax')


def _sources():
    found = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PORT):
        found += [os.path.join(root, f) for f in sorted(files)
                  if f.endswith('.py')]
    return sorted(os.path.relpath(p, REPO) for p in found)


def _imported(tree):
    "(line, top-level package) of every import statement in the tree."
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split('.')[0]


def test_scan_covers_the_port():
    """The scan sees the host copies, the ops, the kernel wrappers, the
    entry points (loader, caches, io, facade, profiler, services, CLI), the
    renderer and viewer, and the GDML, analysis and demo-mesh copies."""
    sources = _sources()
    for name in ('event.py', 'geometry.py', 'likelihood.py', 'native.py',
                 os.path.join('demo', 'optics.py'),
                 os.path.join('ops', 'visit_kernel.py'),
                 os.path.join('ops', 'step_kernel.py'),
                 os.path.join('ops', 'wire_kernel.py'),
                 os.path.join('ops', 'daq_kernel.py'),
                 os.path.join('ops', 'cuda_build.py'),
                 os.path.join('bvh', 'build.py'),
                 os.path.join('bvh', 'bvh.py'), 'loader.py', 'cache.py',
                 'stl.py', 'gpu.py', 'profiler.py',
                 os.path.join('io', 'geocache.py'),
                 os.path.join('io', 'npz.py'), os.path.join('io', 'root.py'),
                 os.path.join('server', 'photon_server.py'),
                 os.path.join('server', 'rat_server.py'),
                 os.path.join('cli', 'sim.py'), os.path.join('cli', 'geo.py'),
                 os.path.join('cli', 'profile.py'),
                 os.path.join('cli', 'server.py'),
                 os.path.join('cli', 'server_rat.py'),
                 os.path.join('cli', 'cam.py'), os.path.join('cli', 'bvh.py'),
                 'camera.py', os.path.join('ops', 'render.py'),
                 os.path.join('ops', 'transform.py'),
                 os.path.join('ops', 'mesh.py'),
                 os.path.join('ops', 'intersect.py'),
                 os.path.join('bvh', 'dfs.py'),
                 os.path.join('color', 'chromaticity.py'),
                 os.path.join('color', 'colormap.py'),
                 os.path.join('models', '__init__.py'), 'csg.py',
                 os.path.join('gdml', 'loader.py'),
                 os.path.join('gdml', 'mesh_gen.py'),
                 os.path.join('histogram', 'histogram.py'),
                 os.path.join('histogram', 'histogramdd.py'),
                 os.path.join('histogram', 'graph.py'),
                 os.path.join('histogram', 'draw.py'), 'parabola.py',
                 'pi0.py', os.path.join('parallel', 'sharding.py'),
                 os.path.join('parallel', 'launch.py')):
        assert os.path.join('chroma_tpu_torch', name) in sources, name


@pytest.mark.parametrize('path', _sources())
def test_no_jax_package_import(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = [(line, top) for line, top in _imported(tree) if top in FORBIDDEN]
    assert not bad, '%s imports %s' % (path, bad)


def test_scan_catches_a_jax_package_import():
    "The scan itself finds imports nested in functions and try blocks."
    tree = ast.parse('def f():\n    try:\n        from chroma_tpu.event '
                     'import Photons\n    except ImportError:\n'
                     '        import jax.numpy\n')
    assert sorted(top for _, top in _imported(tree)) == ['chroma_tpu',
                                                         'jax']


def test_port_reads_its_own_files():
    "Data, kernel and native sources resolve inside chroma_tpu_torch/."
    from chroma_tpu_torch import native
    from chroma_tpu_torch.demo import optics, pmt
    from chroma_tpu_torch.ops import (daq_kernel, step_kernel, visit_kernel,
                                      wire_kernel)
    for path in (optics._DATA, pmt._DATA, native.SOURCE,
                 visit_kernel.SOURCE, step_kernel.SOURCE, wire_kernel.SOURCE,
                 daq_kernel.SOURCE):
        assert os.path.realpath(path).startswith(os.path.realpath(PORT)
                                                 + os.sep), path
        assert os.path.exists(path), path
    assert sorted(os.listdir(optics._DATA)) == sorted(os.listdir(
        os.path.join(REPO, 'chroma_tpu', 'demo', 'data')))
    # the color table and the demo meshes are the port's own files, equal
    # to the originals
    for sub, pattern in (('color', '.csv'), ('models', '.stl'),
                         ('models', '.bz2')):
        names = [n for n in sorted(os.listdir(os.path.join(PORT, sub)))
                 if n.endswith(pattern)]
        assert names == [n for n in sorted(os.listdir(
            os.path.join(REPO, 'chroma_tpu', sub))) if n.endswith(pattern)]
        for n in names:
            with open(os.path.join(PORT, sub, n), 'rb') as a, \
                    open(os.path.join(REPO, 'chroma_tpu', sub, n), 'rb') as b:
                assert a.read() == b.read(), n


HOST_IMPORT = textwrap.dedent('''
    import sys
    import chroma_tpu_torch
    import chroma_tpu_torch.cli.bvh
    import chroma_tpu_torch.cli.geo
    assert 'chroma_tpu_torch.sim' not in sys.modules
    import torch
    assert not torch.cuda.is_initialized()
    assert chroma_tpu_torch.Simulation.__module__ == 'chroma_tpu_torch.sim'
    assert chroma_tpu_torch.Likelihood.__module__ == \\
        'chroma_tpu_torch.likelihood'
    print('OK')
''')


def test_import_starts_no_device_library():
    """`import chroma_tpu_torch`, cli.geo and cli.bvh load neither the
    Simulation nor the Likelihood, and leave torch.cuda uninitialised; both
    load on first use, as chroma_tpu/__init__.py:27-36 has them."""
    proc = subprocess.run([sys.executable, '-c', HOST_IMPORT], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == 'OK'
