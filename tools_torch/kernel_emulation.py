"""Run K2 and K3 on the CPU: their CUDA sources compiled for the host.

    JAX_PLATFORMS=cpu python3 tools_torch/kernel_emulation.py   # ~1 minute

A machine without nvcc cannot build csrc/step_kernel.cu or
csrc/wire_walk.cu, but both are one thread a lane with no shared memory,
so the host C++ compiler can build them against a small header that
stands in for the CUDA runtime (`__device__` functions become inline
functions, a launch becomes a loop over the lanes). The wrappers then
launch them on CPU tensors through the same argument structs. This
checks a kernel's logic against its plain twin before it runs on a card; it
says nothing about the card's rounding (glibc's logf and sinf are not
libdevice's) or speed. It prints, step by step, the lanes where the
host-built K2 differs from after_query_plain on demo.tiny(), the
quick-optics-like box of tests/test_torch_cuda.py and three wire planes,
and whether K3 equals walk_plain.
"""
import contextlib
import ctypes
import os
import re
import subprocess
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chroma_tpu_torch.ops import (cuda_build, photon, step_kernel,  # noqa
                                  visit_kernel, wire_kernel, wireplane)

SHIM = r'''
#pragma once
#include <math.h>
#include <cstring>
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
typedef void* cudaStream_t;
struct cudaFuncAttributes { int x; };
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
template <class T> inline int cudaFuncGetAttributes(cudaFuncAttributes*, T)
{ return 0; }
inline int cudaGetLastError() { return 0; }
struct dim3_ { unsigned x; };
static dim3_ blockIdx, blockDim, threadIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4);
                                     return f; }
'''


def _host_source(source):
    "The kernel source with the shim and every launch made a lane loop."
    text = open(source).read().replace('#include <cuda_runtime.h>',
                                       '#include "cuda_shim.h"')

    def loop(m):
        return ('{ int _nb = %s; for (int _b = 0; _b < _nb; ++_b) '
                'for (int _t = 0; _t < 128; ++_t) { blockIdx.x = _b; '
                'threadIdx.x = _t; blockDim.x = 128; %s(%s); } }'
                % (m.group(2).split(',')[0], m.group(1), m.group(3)))
    return re.sub(r'(\w+)<<<(.*?)>>>\((.*?)\);', loop, text, flags=re.S)


def build_host(source):
    "Compile `source` for the host with g++ (no contraction); load it."
    out = os.path.join(cuda_build.BUILD_DIR, 'emulation')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'cuda_shim.h'), 'w') as fh:
        fh.write(SHIM)
    stem = os.path.splitext(os.path.basename(source))[0]
    cpp = os.path.join(out, stem + '.cpp')
    with open(cpp, 'w') as fh:
        fh.write(_host_source(source))
    lib = os.path.join(out, 'lib%s_host.so' % stem)
    subprocess.run(['g++', '-O1', '-std=c++17', '-shared', '-fPIC',
                    '-ffp-contract=off', '-I', out, '-o', lib, cpp],
                   check=True)
    return ctypes.CDLL(lib)


@contextlib.contextmanager
def host_kernels():
    """Within the block, step_kernel.launch and wire_kernel.launch run the
    host-built kernels on CPU tensors."""
    k2 = build_host(step_kernel.SOURCE)
    k2.chroma_step.argtypes = [step_kernel._Args, ctypes.c_void_p]
    k2.chroma_step.restype = ctypes.c_int
    assert k2.chroma_step_args_size() == ctypes.sizeof(step_kernel._Args)
    k3 = build_host(wire_kernel.SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    k3.chroma_wire_walk.argtypes = [p, p, p, p, i, i, p, p, p, p, p]
    k3.chroma_wire_walk.restype = i
    saved = (step_kernel._lib, wire_kernel._lib, torch.cuda.device,
             torch.cuda.current_stream)
    step_kernel._lib, wire_kernel._lib = k2, k3
    torch.cuda.device = lambda dev: contextlib.nullcontext()
    torch.cuda.current_stream = \
        lambda dev=None: types.SimpleNamespace(cuda_stream=0)
    try:
        yield
    finally:
        (step_kernel._lib, wire_kernel._lib, torch.cuda.device,
         torch.cuda.current_stream) = saved


def _differing(got, ref):
    n = len(ref)
    agree = np.ones(n, bool)
    for name in ('flags', 'last_hit_triangle', 'cur_mat', 'evidx'):
        agree &= getattr(got, name).numpy() == getattr(ref, name).numpy()
    for name in ('pos', 'dir', 'pol', 'wavelength', 't', 'weight'):
        a = getattr(got, name).numpy().reshape(n, -1)
        b = getattr(ref, name).numpy().reshape(n, -1)
        atol = 1e-5 * max(float(np.abs(b).max()), 1.0)
        agree &= np.isclose(a, b, rtol=1e-5, atol=atol).all(axis=1)
    return int((~agree).sum())


def compare(label, ga, state, steps=3):
    "K2 and K3, host-built, against their twins for `steps` steps."
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    for s in range(steps):
        pool = DrawPool(len(state), 'cpu',
                        generator=make_generator('cpu', 1, s))
        ph, active, blocks, pruned, limit = photon.step_prologue(
            state, ga, pool)
        query = visit_kernel.traverse(ga.wide, ph.pos, ph.dir,
                                      ph.last_hit_triangle, mask=active,
                                      best_limit=limit)[:5]
        wires = None
        if ga.has_wireplanes:
            wires = wireplane.walk_plain(ph.pos, ph.dir, ga, active)
            got = wire_kernel.launch(ph.pos, ph.dir, wire_kernel.planes(ga),
                                     active)
            same = all(torch.equal(a, b) for a, b in zip(got, wires))
            print('%s step %d: K3 %s walk_plain' % (
                label, s, 'equals' if same else 'DIFFERS FROM'))
        args = (ph, ga, blocks, active, pruned, query, wires)
        ref = step_kernel.after_query_plain(*args)
        got = step_kernel.launch(*args)
        print('%s step %d: K2 differs from its twin on %d of %d lanes'
              % (label, s, _differing(got, ref), len(ref)))
        state = ref


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tests'))
    import chip_smoke
    from test_torch_cuda import _device_bomb, _optics_box
    from chroma_tpu_torch import demo
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    tiny = demo.tiny()
    tiny.flatten()
    with host_kernels():
        for label, geo in (('tiny', tiny), ('optics box', _optics_box()),
                           ('lartpc-wires', chip_smoke.lartpc_geometry())):
            state = _device_bomb(4096, 5, 'cpu')
            if label == 'lartpc-wires':
                state = state.replace(pos=state.pos + torch.tensor(
                    [0.0, 0.0, -40.0]))
            compare(label, build_geometry_arrays(geo), state)


if __name__ == '__main__':
    main()
