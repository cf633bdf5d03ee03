#!/usr/bin/env python3
"""Count how often torch's CPU sqrt returns a wrong share on its first
call in a fresh process.

    python3 tools_torch/sqrt_first_call.py [runs] [workers]

Each run is a fresh interpreter that takes two torch threads and computes
torch.sqrt of 5,000 f32 values in [0.1, 3) twice, holding both results to
numpy's f64 sqrt (relative error 1e-6), in three variants: the sqrt
first; after one torch.cos of the same tensor; after
`import chroma_tpu_torch.ops`, which makes one single-element sqrt. Runs
of the three variants are spread over `workers` processes at once (more
load makes the fault likelier). Prints, per variant, the runs whose first
or second call had wrong values, and which lanes. CPU only.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(2)
variant, seed = sys.argv[1], int(sys.argv[2])
if variant == 'port':
    import chroma_tpu_torch.ops  # noqa: F401
x = torch.from_numpy(np.random.RandomState(seed).uniform(
    0.1, 3.0, 5000).astype(np.float32))
if variant == 'cos first':
    torch.cos(x)
want = np.sqrt(x.double().numpy())
out = []
for call in (1, 2):
    rel = np.abs(torch.sqrt(x).double().numpy() - want) / want
    bad = np.flatnonzero(rel > 1e-6)
    if len(bad):
        out.append('call %d: %d lanes wrong [%d..%d], up to %.2g' % (
            call, len(bad), bad[0], bad[-1], rel.max()))
print('; '.join(out) or 'ok')
'''

VARIANTS = ('sqrt first', 'cos first', 'port')


def one(job):
    variant, seed = job
    proc = subprocess.run([sys.executable, '-c', PROBE, variant, str(seed)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    return variant, (proc.stdout.strip().splitlines() or ['no output'])[-1]


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 240
    workers = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    jobs = [(v, seed) for seed in range(runs) for v in VARIANTS]
    bad = {v: [] for v in VARIANTS}
    with ThreadPoolExecutor(workers) as pool:
        for variant, result in pool.map(one, jobs):
            if result != 'ok':
                bad[variant].append(result)
    for variant in VARIANTS:
        print('%-10s %d of %d fresh runs wrong' % (variant, len(bad[variant]),
                                                   runs))
        for line in bad[variant]:
            print('    ' + line)


if __name__ == '__main__':
    main()
