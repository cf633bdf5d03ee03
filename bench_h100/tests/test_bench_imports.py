"""What the benchmark may load and read: no module whose top-level name,
compared whole, is jax, jaxlib, flax or chroma_tpu (chroma_tpu_torch is
the program and allowed), and no read of the JAX benchmark's files."""
from __future__ import annotations

import ast
import os
import sys
import types

import pytest

from bench_h100.harness import cell

SOURCES = [os.path.join(d, f) for d, _, fs in os.walk(cell.BENCH)
           for f in fs if f.endswith('.py')
           and '.cache' not in d and '__pycache__' not in d]


@pytest.mark.parametrize('path', SOURCES,
                         ids=lambda p: os.path.relpath(p, cell.BENCH))
def test_sources_import_no_jax(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in cell.FORBIDDEN, (path, name)
    if path != __file__:
        text = open(path).read()
        for word in ('bench' + '.py', 'BENCH' + '_', 'MULTICHIP' + '_'):
            assert word not in text, (path, word)


def test_forbidden_names_compare_whole(monkeypatch):
    assert cell.forbidden_modules() == []
    for name in ('chroma_tpu_torch_extra', 'jaxtyping', 'flaxen.x'):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'chroma_tpu.ops',
                        types.ModuleType('chroma_tpu.ops'))
    monkeypatch.setitem(sys.modules, 'jaxlib', types.ModuleType('jaxlib'))
    assert cell.forbidden_modules() == ['chroma_tpu', 'jaxlib']
