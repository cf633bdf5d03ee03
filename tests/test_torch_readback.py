"""The end-state readback (ops.propagate.photon_state_to_host) on the CPU.

Every field of event.Photons comes back as the field-by-field
`.cpu().numpy()` route gives it, bit for bit, in dtype, shape and value,
with no channel, a host channel or a device channel (clamped at 0 and
read as uint32); the arrays are the readback's own, not views of the
state."""
import numpy as np
import pytest
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops.photon import PhotonState
from chroma_tpu_torch.ops.propagate import photon_state_to_host

N = 3001
FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't', 'last_hit_triangles',
          'flags', 'weights', 'evidx', 'channel')


def seeded_state(n, seed):
    "A PhotonState of random bits: every float and int pattern a lane holds."
    gen = torch.Generator().manual_seed(seed)

    def f32(*shape):
        return torch.randn(shape, generator=gen) * 1e3

    def i32(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32)
    state = PhotonState(
        pos=f32(n, 3), dir=f32(n, 3), pol=f32(n, 3), wavelength=f32(n),
        t=f32(n), weight=f32(n), flags=i32(-2 ** 31, 2 ** 31 - 1),
        last_hit_triangle=i32(-2, 1 << 20), evidx=i32(-2 ** 31, 2 ** 31 - 1),
        cur_mat=i32(-1, 8))
    state.t[:7] = float('nan')
    return state


def pageable(state, channel=None):
    "The readback as it was: each field's .cpu().numpy()."
    h = state.map(lambda a: a.cpu().numpy())
    return event.Photons(
        pos=h.pos, dir=h.dir, pol=h.pol, wavelengths=h.wavelength, t=h.t,
        last_hit_triangles=h.last_hit_triangle,
        flags=h.flags.view(np.uint32), weights=h.weight,
        evidx=h.evidx.view(np.uint32), channel=channel)


def assert_bit_equal(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize('channel', ['none', 'numpy', 'tensor'])
def test_readback_equals_pageable_route(channel):
    state = seeded_state(N, 5)
    ch = torch.randint(-1, 40, (N,), generator=torch.Generator()
                       .manual_seed(6), dtype=torch.int32)
    want_ch = np.maximum(ch.numpy(), 0).astype(np.uint32)
    given = {'none': None, 'numpy': want_ch, 'tensor': ch}[channel]
    got = photon_state_to_host(state, channel=given)
    assert_bit_equal(got, pageable(state, None if channel == 'none'
                                   else want_ch))
    if channel == 'tensor':
        assert (ch == -1).any()      # the clamp had work to do
        assert (ch.numpy() >= -1).all()  # and left the tensor as it was


def test_readback_arrays_are_its_own():
    "Writing the state after the readback leaves the arrays as they were."
    state = seeded_state(N, 7)
    got = photon_state_to_host(state)
    want = pageable(state.map(torch.clone))
    state.map(lambda a: a.zero_())
    assert_bit_equal(got, want)


def test_readback_of_no_lanes():
    got = photon_state_to_host(seeded_state(0, 1),
                               channel=torch.zeros(0, dtype=torch.int32))
    assert len(got) == 0 and got.pos.shape == (0, 3)
    assert got.channel.dtype == np.uint32
