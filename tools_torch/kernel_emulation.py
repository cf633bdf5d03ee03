"""Run K2, K3 and K4 on the CPU: their CUDA sources compiled for the host.

    JAX_PLATFORMS=cpu python3 tools_torch/kernel_emulation.py   # ~1 minute

A machine without nvcc cannot build csrc/step_kernel.cu,
csrc/wire_walk.cu or csrc/daq_kernel.cu, but the host C++ compiler can
build them against a small header that stands in for the CUDA runtime
(`__device__` functions become inline functions). A launch runs its
blocks one after another, and each block's threads as real threads
(POSIX threads), so that what the kernels share within a block behaves
as on the card: `__syncthreads()` is a barrier of the block's threads,
`__syncwarp()`, the shuffles and `__ballot_sync` exchange values through
a barrier of the warp's 32 threads, `extern __shared__` memory is the
block's own, and the atomics (`atomicMin`, `atomicAdd`, `atomicOr`) are
the host's. The wrappers then launch the host builds on CPU tensors
through the same arguments. This checks a kernel's logic (its barriers
and exchanges included) against its plain twin before it runs on a card;
it says nothing about the card's rounding (glibc's logf and sinf are not
libdevice's), its scheduling or its speed.
As a script it prints, step by step, the lanes where the host-built K2
(k2_pre, then k2_post) differs from its twins on demo.tiny(), the
all-models box of tests/test_torch_cuda.py and three wire planes, and
whether K3 equals walk_plain. tests/test_torch_kernel_emulation.py holds
the same comparisons, and tests/test_torch_daq.py holds K4 to its twin
(`host_kernels((daq_kernel,))`).
"""
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chroma_tpu_torch.ops import (cuda_build, daq_kernel, photon,  # noqa
                                  step_kernel, visit_kernel, wire_kernel,
                                  wireplane)

SHIM = r'''
#pragma once
#include <math.h>
#include <pthread.h>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
typedef void* cudaStream_t;
struct cudaFuncAttributes { int x; };
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T> inline int cudaFuncGetAttributes(cudaFuncAttributes*, T)
{ return 0; }
template <class T> inline int cudaFuncSetAttribute(T, cudaFuncAttribute, int)
{ return 0; }
inline int cudaGetLastError() { return 0; }
struct dim3_ { unsigned x; };

namespace emu {
// one block's shared state: its dynamic shared memory, its barrier and
// each warp's barrier and exchange slots
struct Block {
    std::vector<unsigned long long> smem;
    std::unique_ptr<std::barrier<>> all;
    std::vector<std::unique_ptr<std::barrier<>>> warp;
    std::vector<unsigned long long> slots;
};
inline thread_local dim3_ block_idx, thread_idx, block_dim;
inline thread_local Block* block;

struct Start {
    Block* b;
    unsigned bx, tx, nb;
    const std::function<void()>* fn;
};
inline void* run(void* p) {
    Start* s = static_cast<Start*>(p);
    block = s->b;
    block_idx.x = s->bx;
    thread_idx.x = s->tx;
    block_dim.x = s->nb;
    (*s->fn)();
    return nullptr;
}

// kernel<<<grid, threads, smem, stream>>>(...): the blocks in turn, the
// threads of a block at once
inline void launch(unsigned grid, unsigned threads, size_t smem,
                   const std::function<void()>& fn) {
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setstacksize(&attr, 1 << 20);
    for (unsigned bx = 0; bx < grid; ++bx) {
        Block b;
        b.smem.assign(smem / 8 + 1, 0ull);
        b.all = std::make_unique<std::barrier<>>(threads);
        for (unsigned w = 0; w * 32 < threads; ++w)
            b.warp.push_back(std::make_unique<std::barrier<>>(
                threads - 32 * w < 32 ? threads - 32 * w : 32));
        b.slots.assign(32 * b.warp.size(), 0ull);
        std::vector<Start> starts(threads);
        std::vector<pthread_t> ids(threads);
        for (unsigned t = 0; t < threads; ++t) {
            starts[t] = Start{&b, bx, t, threads, &fn};
            pthread_create(&ids[t], &attr, run, &starts[t]);
        }
        for (unsigned t = 0; t < threads; ++t) pthread_join(ids[t], nullptr);
    }
    pthread_attr_destroy(&attr);
}

inline unsigned lane() { return thread_idx.x & 31; }
inline std::barrier<>& warp_barrier() {
    return *block->warp[thread_idx.x >> 5];
}
// every lane posts v; returns what lane src posted
template <class T> inline T exchange(T v, unsigned src) {
    unsigned long long bits = 0;
    std::memcpy(&bits, &v, sizeof(T));
    unsigned long long* s = &block->slots[32 * (thread_idx.x >> 5)];
    s[lane()] = bits;
    warp_barrier().arrive_and_wait();
    bits = s[src & 31];
    warp_barrier().arrive_and_wait();
    T r;
    std::memcpy(&r, &bits, sizeof(T));
    return r;
}
}  // namespace emu

#define blockIdx emu::block_idx
#define threadIdx emu::thread_idx
#define blockDim emu::block_dim

inline void __syncthreads() { emu::block->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    emu::warp_barrier().arrive_and_wait();
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
    return emu::exchange(v, (unsigned)src);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
    unsigned l = emu::lane();
    return emu::exchange(v, l >= d ? l - d : l);
}
inline unsigned __ballot_sync(unsigned, int pred) {
    unsigned long long* s = &emu::block->slots[32 * (threadIdx.x >> 5)];
    s[emu::lane()] = pred != 0;
    emu::warp_barrier().arrive_and_wait();
    unsigned m = 0;
    for (unsigned k = 0; k < 32; ++k) m |= (unsigned)(s[k] != 0) << k;
    emu::warp_barrier().arrive_and_wait();
    return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned long long atomicMin(unsigned long long* p,
                                    unsigned long long v) {
    unsigned long long old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
    while (v < old && !__atomic_compare_exchange_n(
               p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
    }
    return old;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4);
                                     return f; }
inline float __uint_as_float(unsigned i) { float f; std::memcpy(&f, &i, 4);
                                           return f; }
inline unsigned __float_as_uint(float f) { unsigned i; std::memcpy(&i, &f, 4);
                                           return i; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4);
                                     return i; }
inline int atomicMin(int* p, int v) {
    int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
    while (v < old && !__atomic_compare_exchange_n(
               p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
    }
    return old;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicOr(int* p, int v) {
    return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
'''


def _split_top(text):
    "`text` split at its commas outside parentheses."
    parts, depth, cur = [], 0, ''
    for ch in text:
        if ch == ',' and depth == 0:
            parts.append(cur)
            cur = ''
            continue
        depth += (ch == '(') - (ch == ')')
        cur += ch
    return parts + [cur]


def _host_source(source):
    """The kernel source with the shim, `extern __shared__` arrays made
    the block's memory and every launch a call of emu::launch."""
    text = open(source).read().replace('#include <cuda_runtime.h>',
                                       '#include "cuda_shim.h"')
    text = re.sub(r'extern __shared__ ([\w ]+?) (\w+)\[\];',
                  r'\1* \2 = reinterpret_cast<\1*>('
                  r'emu::block->smem.data());', text)
    out, pos = '', 0
    for m in re.finditer(r'(\w+)<<<', text):
        if m.start() < pos:
            continue
        close = text.index('>>>', m.end())
        config = _split_top(text[m.end():close])
        depth, i = 0, close + 3
        while True:                      # the argument list's parentheses
            depth += (text[i] == '(') - (text[i] == ')')
            i += 1
            if depth == 0:
                break
        args = text[close + 3:i]
        end = text.index(';', i) + 1
        out += text[pos:m.start()] + (
            'emu::launch((unsigned)(%s), (unsigned)(%s), (size_t)(%s), '
            '[&]() { %s%s; });' % (config[0], config[1],
                                   config[2] if len(config) > 2 else '0',
                                   m.group(1), args))
        pos = end
    return out + text[pos:]


def build_host(source):
    """Compile `source` for the host with g++ (C++20, no contraction) into
    build/emulation, once per content; load it. Raises RuntimeError when
    g++ is missing or fails."""
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ is not installed')
    out = os.path.join(cuda_build.BUILD_DIR, 'emulation')
    os.makedirs(out, exist_ok=True)
    code = _host_source(source)
    digest = hashlib.sha256((SHIM + code).encode()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(out, 'lib%s_host_%s.so' % (stem, digest))
    if not os.path.exists(lib):
        work = os.path.join(out, '%s.%d' % (digest, os.getpid()))
        os.makedirs(work, exist_ok=True)
        with open(os.path.join(work, 'cuda_shim.h'), 'w') as fh:
            fh.write(SHIM)
        cpp = os.path.join(work, stem + '.cpp')
        with open(cpp, 'w') as fh:
            fh.write(code)
        proc = subprocess.run(
            [gxx, '-O1', '-std=c++20', '-shared', '-fPIC', '-pthread',
             '-ffp-contract=off', '-I', work, '-o', lib + '.tmp', cpp],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('g++ failed on %s:\n%s' % (source,
                                                          proc.stderr))
        os.replace(lib + '.tmp', lib)
        shutil.rmtree(work, ignore_errors=True)
    return ctypes.CDLL(lib)


@contextlib.contextmanager
def host_kernels(modules=(step_kernel, wire_kernel)):
    """Within the block, the launches of the kernel wrappers `modules`
    (K2's and K3's by default; daq_kernel for K4) run the host-built
    kernels on CPU tensors: each wrapper's library is its host build, and
    cuda_build.stream selects no device and passes a null stream."""
    libs = []
    for mod in modules:
        libs.append(build_host(mod.SOURCE))
        mod.library.bind(libs[-1])
    saved = [mod.library.lib for mod in modules], cuda_build.stream
    for mod, lib in zip(modules, libs):
        mod.library.lib = lib
    cuda_build.stream = lambda dev: contextlib.nullcontext(0)
    try:
        yield
    finally:
        for mod, lib in zip(modules, saved[0]):
            mod.library.lib = lib
        cuda_build.stream = saved[1]


def differing(got, ref, fields=None):
    """Lanes of two PhotonStates that differ: an integer field unequal or
    a float beyond rtol 1e-5 (absolute floor 1e-5 of the field's scale)."""
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


def prologue_differs(got, ref):
    """k2_pre's outputs against step_prologue's: (flags and masks equal,
    lanes whose limit is beyond rtol 1e-5)."""
    ph, active, _, pruned, limit = got
    rph, ractive, _, rpruned, rlimit = ref
    same = torch.equal(ph.flags, rph.flags) and torch.equal(active, ractive)
    if rpruned is None:
        return same and pruned is None, 0
    same = same and torch.equal(pruned, rpruned)
    close = torch.isclose(limit, rlimit, rtol=1e-5) | (
        torch.isinf(limit) & torch.isinf(rlimit))
    return same, int((~close).sum())


def compare(label, ga, state, steps=3, block=None):
    "k2_pre, k2_post and K3, host-built, against their twins."
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    for s in range(steps):
        pool = DrawPool(len(state), 'cpu',
                        generator=make_generator('cpu', 1, s))
        ref_pre = photon.step_prologue(state, ga, pool)
        ph, active, blocks, pruned, limit = ref_pre
        got_pre = step_kernel.launch_pre(state, ga, blocks,
                                         pruned is not None)
        same, far = prologue_differs(got_pre, ref_pre)
        print('%s step %d: k2_pre %s step_prologue in flags and masks, '
              '%d limits beyond rtol 1e-5' % (
                  label, s, 'equals' if same else 'DIFFERS FROM', far))
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
        got = step_kernel.launch(*args, block=block)
        print('%s step %d: k2_post differs from its twin on %d of %d lanes'
              % (label, s, differing(got, ref), len(ref)))
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
