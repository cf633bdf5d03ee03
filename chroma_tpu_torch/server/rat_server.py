"""Packed-binary photon service for RAT/C++ clients
(reference: bin/chroma-server-rat:28-70).

Wire format (little endian):
  request:  uint32 nphotons, uint32 eventid,
            11 x float64[nphotons] (x y z dx dy dz polx poly polz
            wavelength t), uint32 trackid[nphotons]
  reply:    uint32 nhits, uint32 eventid, the same 11 arrays for the hit
            photons (float32, matching the reference), then
            uint32 channel[nhits] twice (the second copy stands in for
            track ids, as in the reference).
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch import event
from chroma_tpu_torch.log import logger


def parse_request(msg):
    "Unpack a request into (Photons, eventid, trackids)."
    nphotons, eventid = np.frombuffer(msg[:8], dtype=np.uint32)
    n = int(nphotons)
    body = np.frombuffer(msg[8:8 + 8 * 11 * n], dtype=np.float64)
    x, y, z, dx, dy, dz, polx, poly, polz, wavelen, t = np.split(body, 11)
    trackid = np.frombuffer(msg[8 + 8 * 11 * n:], dtype=np.uint32)
    photons = event.Photons(np.column_stack([x, y, z]),
                            np.column_stack([dx, dy, dz]),
                            np.column_stack([polx, poly, polz]),
                            wavelen, t)
    return photons, int(eventid), trackid


def pack_reply(hitphotons, channels, eventid):
    "Pack hit photons + channel ids into the RAT reply format."
    parts = [np.asarray([len(hitphotons), eventid],
                        dtype=np.uint32).tobytes()]
    for col in (hitphotons.pos[:, 0], hitphotons.pos[:, 1],
                hitphotons.pos[:, 2], hitphotons.dir[:, 0],
                hitphotons.dir[:, 1], hitphotons.dir[:, 2],
                hitphotons.pol[:, 0], hitphotons.pol[:, 1],
                hitphotons.pol[:, 2], hitphotons.wavelengths,
                hitphotons.t):
        parts.append(np.ascontiguousarray(col).tobytes())
    chan = np.asarray(channels, dtype=np.uint32)
    parts.append(chan.tobytes())
    parts.append(chan.tobytes())  # stand-in for track ids (reference FIXME)
    return b''.join(parts)


class RatServer(object):
    "ZeroMQ REP server speaking the RAT binary protocol."

    def __init__(self, address, detector, sim=None, **sim_kwargs):
        import zmq
        self.address = address
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.REP)
        self.socket.bind(address)
        if sim is None:
            from chroma_tpu_torch.sim import Simulation
            sim = Simulation(detector, **sim_kwargs)
        self.sim = sim

    def serve_forever(self, max_requests=None):
        served = 0
        while max_requests is None or served < max_requests:
            msg = self.socket.recv()
            photons, eventid, _ = parse_request(msg)
            logger.info('received %d photons for event %d'
                        % (len(photons), eventid))

            ev = next(self.sim.simulate(photons, keep_photons_beg=False,
                                        keep_photons_end=False,
                                        keep_hits=True, run_daq=False,
                                        max_steps=1000))

            hits = ev.hits or {}
            chans = list(hits.keys())
            hitphotons = event.Photons()
            chanidxes = np.empty(shape=(0,), dtype=np.uint32)
            for chan in chans:
                hitphotons = hitphotons + hits[chan]
                chanidxes = np.concatenate(
                    [chanidxes,
                     np.full(len(hits[chan]), chan, dtype=np.uint32)])

            self.socket.send(pack_reply(hitphotons, chanidxes, eventid))
            served += 1

    def close(self):
        self.socket.close(0)
        self.context.term()
