"""A liquid-argon TPC on the port's main path, on the CPU: a detector with
wire planes and channels goes through the geocache as the benchmark's
`lartpc` cell loads it (save_geometry_arrays, load_geometry_arrays,
Simulation(None, gpu_geometry=...)) and simulates exactly as the unsaved
geometry does; the driver counts the lanes K3 walks (wire.walked) on such
a geometry only."""
import dataclasses

import numpy as np
import pytest
import torch

from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.generator import photon_bomb
from chroma_tpu_torch.geometry import Material, Solid, Surface, WirePlane
from chroma_tpu_torch.io.geocache import (load_geometry_arrays,
                                          save_geometry_arrays)
from chroma_tpu_torch.make import box
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.ops.types import build_geometry_arrays
from chroma_tpu_torch.profiler import profiler
from chroma_tpu_torch.sim import Simulation

from test_torch_host import fresh_perf_cache  # noqa: F401

torch.set_num_threads(2)

N = 4096


def small_tpc():
    """A 600 x 400 x 400 mm liquid-argon box with absorbing walls, three
    anode planes (U/V at +-60 degrees from the vertical, Y vertical; 3 mm
    pitch, 0.075 mm wires, 3 mm apart from x = 200 mm) and two
    photocathode boxes behind them, one channel each."""
    lar = Material('lar')
    lar.set('refractive_index', 1.38)
    lar.set('absorption_length', 1e9)
    lar.set('scattering_length', 600.0)
    metal = Material('metal')
    metal.set('refractive_index', 1.5)
    metal.set('absorption_length', 1e-3)
    metal.set('scattering_length', 1e6)
    black = Surface('black')
    black.set('absorb', 1.0)
    wire = Surface('wire')
    wire.set('absorb', 1.0)
    cathode = Surface('cathode')
    cathode.set('detect', 0.5)
    cathode.set('absorb', 0.5)
    det = Detector(lar)
    det.add_solid(Solid(box(700.0, 400.0, 400.0, center=(50.0, 0.0, 0.0)),
                        lar, lar, surface=black))
    for z in (-100.0, 100.0):
        det.add_pmt(Solid(box(20.0, 150.0, 150.0), metal, lar,
                          surface=cathode), displacement=(260.0, 0.0, z))
    for i, deg in enumerate((60.0, -60.0, 0.0)):
        a = np.radians(deg)
        c, s = np.cos(a), np.sin(a)
        det.add_wireplane(WirePlane(
            origin=(200.0 + 3.0 * i, 0.0, 0.0), u=(0.0, c, s),
            v=(0.0, -s, c), pitch=3.0, radius=0.075, umin=-300, umax=300,
            vmin=-300, vmax=300, surface=wire, material_inner=metal,
            material_outer=lar))
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    return det


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    "(the unsaved build, the same build saved and loaded)."
    ga = build_geometry_arrays(small_tpc())
    path = str(tmp_path_factory.mktemp('geocache') / 'tpc')
    save_geometry_arrays(path, ga)
    return ga, load_geometry_arrays(path)


def _bomb(ga, monkeypatch):
    "A 128 nm bomb through Simulation.simulate on `ga`, its schedule fixed."
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2')
    np.random.seed(4)
    photons = photon_bomb(N, 128.0, (0.0, 0.0, 0.0))
    sim = Simulation(None, gpu_geometry=ga, seed=9, device='cpu')
    return next(sim.simulate(photons, keep_photons_end=True, run_daq=True,
                             max_steps=40, photons_per_batch=N))


def test_wire_planes_and_channels_survive_the_geocache(saved):
    ga, loaded = saved
    assert loaded.has_wireplanes and loaded.has_detector
    for f in dataclasses.fields(ga.wireplanes):
        a, b = getattr(ga.wireplanes, f.name), getattr(loaded.wireplanes,
                                                       f.name)
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), f.name
    for f in dataclasses.fields(ga.detector):
        a, b = getattr(ga.detector, f.name), getattr(loaded.detector, f.name)
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), f.name


def test_loaded_geometry_simulates_as_the_unsaved_one(saved, monkeypatch):
    """The same bomb, seed and schedule on the unsaved and the loaded
    geometry: end states and channels equal; photons end on the wires, on
    the walls and in the photocathodes."""
    ga, loaded = saved
    want = _bomb(ga, monkeypatch)
    got = _bomb(loaded, monkeypatch)
    for name in ('pos', 'dir', 'pol', 't', 'flags', 'last_hit_triangles'):
        assert np.array_equal(getattr(got.photons_end, name),
                              getattr(want.photons_end, name)), name
    for name in ('hit', 't', 'q'):
        assert np.array_equal(getattr(got.channels, name),
                              getattr(want.channels, name)), name
    last = want.photons_end.last_hit_triangles
    assert (last == -2).sum() > 50 and (last >= 0).sum() > 1000
    assert want.channels.hit.all()


def test_wire_walked_counts_lane_steps_on_wire_planes(saved, monkeypatch):
    """wire.walked, the lanes K3 walks, is propagate.lane_steps on a
    geometry with wire planes, counted once a stage."""
    ga, _ = saved
    monkeypatch.setattr(profiler, 'enabled', True)
    monkeypatch.setattr(profiler, 'counters', type(profiler.counters)(int))
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2')
    np.random.seed(5)
    state = tprop.photon_state_from_host(
        photon_bomb(N, 128.0, (0.0, 0.0, 0.0)), 'cpu')
    tprop.propagate(state, ga, seed=3, max_steps=20)
    c = profiler.counters
    assert c['propagate.lane_steps'] > 0
    assert c['wire.walked'] == c['propagate.lane_steps']
