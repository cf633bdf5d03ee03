"""pi0 -> gamma gamma decay kinematics (reference: chroma/pi0.py).

Used to build two-photon vertices for reconstruction studies. Energies are
MeV, directions unit vectors, velocities in units of c.
"""
from __future__ import annotations

import numpy as np

PI0_MASS_MEV = 134.9766


def boost_to_lab(energy, momentum, v):
    """Lorentz-boost a particle's (energy, momentum 3-vector) from a frame
    moving with velocity `v` (units of c) into the lab frame. Natural
    units: E and |p| in MeV."""
    e0 = float(energy)
    p0 = np.asarray(momentum, float)
    v = np.asarray(v, float)
    beta = np.linalg.norm(v)
    if beta == 0:
        return e0, p0
    gamma = 1.0 / np.sqrt(1.0 - beta * beta)
    n = v / beta

    p_par = np.dot(p0, n)
    p = p0 + ((gamma - 1.0) * p_par + gamma * beta * e0) * n
    e = gamma * (e0 + beta * p_par)
    return e, p


# API-compatible alias for the reference's name
def rocket_to_lab(energy, momentum, v):
    return boost_to_lab(energy, momentum, v)


def pi0_decay(energy, direction, theta, phi):
    """Lab-frame energies/directions of the two photons from a pi0 decay,
    with the first photon emitted at rest-frame polar angles (theta, phi).

    Returns ((e1, v1), (e2, v2)) with energies in MeV and unit vectors."""
    direction = np.asarray(direction) / np.linalg.norm(direction)
    e_pi0 = float(energy)
    p_pi0 = np.sqrt(max(e_pi0 ** 2 - PI0_MASS_MEV ** 2, 0.0)) * direction
    v_pi0 = p_pi0 / e_pi0

    e_rest = PI0_MASS_MEV / 2.0
    p_rest = e_rest * np.array([np.cos(phi) * np.sin(theta),
                                np.sin(phi) * np.sin(theta),
                                np.cos(theta)])

    e1, p1 = boost_to_lab(e_rest, p_rest, v_pi0)
    e2, p2 = boost_to_lab(e_rest, -p_rest, v_pi0)
    return ((e1, p1 / np.linalg.norm(p1)),
            (e2, p2 / np.linalg.norm(p2)))
