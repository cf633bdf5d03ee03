"""Walls of the lartpc-wires bomb on the card, for the checkout this file
sits in: chip_smoke.py phase 7's geometry and 2^20 photons (numpy seed
11, run_daq=False, keep_photons_end), one Simulation, a bomb a route in
the order given, then one eager propagate_step of the same photons at
full width from step 0.

Compare two commits on one card by running it from both checkouts in
turns in one call (copy this file into the other checkout's
tools_torch/ first):

    python3 tools_torch/lartpc_walls.py --routes default,chunked,default

A route is `default` (CHROMA_FUSED unset: the fused driver where the
checkout has one), `fused` or `chunked` (CHROMA_FUSED=1 / 0). Prints one
JSON line: the card's name and power limit, each bomb's wall and K1
launches, and the step's milliseconds.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)


def main(argv):
    import numpy as np
    import torch
    import chip_smoke
    import chroma_tpu_torch
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch.ops import visit_kernel
    from chroma_tpu_torch.ops.photon import propagate_step
    from chroma_tpu_torch.ops.propagate import photon_state_from_host
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    routes = (argv[argv.index('--routes') + 1] if '--routes' in argv
              else 'default,default,default').split(',')
    visit_kernel.library.load()
    geo = chip_smoke.lartpc_geometry()
    ga = build_geometry_arrays(geo)
    sim = chroma_tpu_torch.Simulation(geo, seed=0, device='cuda',
                                      geometry_arrays=ga)
    source = (0.0, 0.0, -300.0)
    bombs = []
    for route in routes:
        if route == 'default':
            os.environ.pop('CHROMA_FUSED', None)
        else:
            os.environ['CHROMA_FUSED'] = '1' if route == 'fused' else '0'
        _, wall, aborts, launches = chip_smoke.run_main_path(
            sim, chip_smoke.N_BOMB, 11, pos=source, run_daq=False)
        assert aborts == 0 and launches > 0
        bombs.append(dict(route=route, wall_s=wall, launches=launches))
    os.environ.pop('CHROMA_FUSED', None)

    np.random.seed(11)
    dev = torch.device('cuda', 0)
    state = photon_state_from_host(
        photon_bomb(chip_smoke.N_BOMB, 400.0, source), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    propagate_step(state, sim.gpu_geometry,
                   DrawPool(len(state), dev,
                            generator=make_generator(dev, 5, 0)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps(dict(card=chip_smoke.card_line(), root=ROOT,
                          bombs=bombs, first_step_ms=step_ms)), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
