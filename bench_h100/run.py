"""The benchmark of chroma_tpu_torch on an NVIDIA H100: one run of one
cell.

    python3 bench_h100/run.py --workload quick.bomb --seed 7 --seconds 40 \
        --trace 0

Sets up the cell (BENCHMARK.json names it; its files are found by name),
warms its shapes, drives the program for --seconds in a closed loop,
judges what the window produced against the plain reference, and prints
the numbers compared (standard error, last lines) and the result as the
last line of standard output. Without a card it exits 2 and prints no
result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def environment():
    """Caches inside the checkout at fixed paths; libraries kept from
    loading JAX."""
    cache = os.path.join(HERE, '.cache')
    os.environ['CHROMA_CACHE_DIR'] = cache
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    import torch
    from bench_h100.harness import cell
    spec = cell.load_spec(ROOT)
    work = cell.find(spec['workloads'], args.workload, 'workload')
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(work['chips']):
        print('needs %d CUDA device(s); found %s' % (
            work['chips'], torch.cuda.device_count()
            if torch.cuda.is_available() else 'none'), file=sys.stderr)
        return 2
    ctx = cell.context(args.workload, args.seed, 'cuda:0', spec)
    result, compared = cell.run_cell(ctx, args.seconds, bool(args.trace),
                                     T_PROCESS)
    for name, c in compared.items():
        print('compared %s %r limit %r' % (name, c['value'], c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
