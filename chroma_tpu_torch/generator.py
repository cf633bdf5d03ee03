"""Photon/vertex generators.

The upstream reference generated photons with embedded GEANT4 worker
processes; this fork's reference dropped that layer but its tests and the
likelihood driver still expect a vertex source (SURVEY §4 drift). This
module provides the working equivalents:

  * photon_bomb — isotropic point source of monochromatic photons
  * constant_photon_bomb_gun — endless Event stream of identical bombs
  * constant_particle_gun — Vertex stream (API parity with the removed
    chroma.generator.vertex.constant_particle_gun)
  * photons_from_vertex — a simple parametric light model (isotropic,
    flat 300-600 nm spectrum, ~N photons/MeV) standing in for the GEANT4
    particle simulation so the likelihood/PDF path runs end to end
"""
from __future__ import annotations

from itertools import count

import numpy as np

from chroma_tpu_torch import event
from chroma_tpu_torch.sample import uniform_sphere


def photon_bomb(nphotons, wavelength, pos, t0=0.0):
    "Isotropic point source of `nphotons` photons at wavelength (nm)."
    pos = np.tile(pos, (nphotons, 1)).astype(np.float32)
    dir = uniform_sphere(nphotons)
    pol = np.cross(uniform_sphere(nphotons), dir)
    pol /= np.linalg.norm(pol, axis=1, keepdims=True)
    wavelengths = np.full(nphotons, wavelength, dtype=np.float32)
    t = np.full(nphotons, t0, dtype=np.float32)
    return event.Photons(pos, dir, pol, wavelengths, t)


def constant_photon_bomb_gun(nphotons, wavelength, pos, t0=0.0):
    "Endless iterator of Events with identical photon bombs."
    for i in count():
        ev = event.Event(id=i, photons_beg=photon_bomb(nphotons,
                                                       wavelength, pos, t0))
        yield ev


def constant_particle_gun(particle_name, pos, dir, ke, t0=0.0,
                          start_id=0):
    """Endless iterator of identical particle Vertex objects
    (API of the removed chroma.generator.vertex.constant_particle_gun)."""
    pos = np.asarray(pos, dtype=float)
    dir = np.asarray(dir, dtype=float)
    dir = dir / np.linalg.norm(dir)
    for i in count(start_id):
        yield event.Vertex(particle_name, pos.copy(), dir.copy(), ke,
                           t0=t0)


def photons_from_vertex(vertex, photons_per_mev=1000,
                        wavelength_range=(300.0, 600.0)):
    """Parametric light model: an isotropic photon bomb at the vertex with
    a flat spectrum and yield proportional to kinetic energy. A stand-in
    for GEANT4 particle transport; adequate for likelihood/PDF exercises
    where only the source position/time matter."""
    n = max(int(vertex.ke * photons_per_mev), 1)
    photons = photon_bomb(n, 0.0, vertex.pos, t0=vertex.t0)
    photons.wavelengths = np.random.uniform(
        wavelength_range[0], wavelength_range[1], n).astype(np.float32)
    return photons


def vertex_gun_to_events(vertex_iterable, photons_per_mev=1000):
    "Wrap a Vertex iterator into an Event iterator with photons attached."
    for i, vertex in enumerate(vertex_iterable):
        ev = event.Event(id=i, vertices=[vertex],
                         photons_beg=photons_from_vertex(
                             vertex, photons_per_mev))
        yield ev
