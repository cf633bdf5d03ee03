"""Pickle-protocol photon service (reference: bin/chroma-server:20-39)."""
from __future__ import annotations

from chroma_tpu_torch.log import logger


class PhotonServer(object):
    """ZeroMQ REP server: receives pickled Photons, replies with the
    propagated Photons. Stateless per request — a client retry after any
    failure is the recovery story, as in the reference."""

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
        "Listen for photons, propagate, reply with final states."
        served = 0
        while max_requests is None or served < max_requests:
            photons_in = self.socket.recv_pyobj()
            logger.info('processing %d photons' % len(photons_in))
            photons_end = next(self.sim.simulate(
                photons_in, keep_photons_end=True)).photons_end
            self.socket.send_pyobj(photons_end)
            served += 1

    def close(self):
        self.socket.close(0)
        self.context.term()


class PhotonClient(object):
    "REQ-side counterpart of PhotonServer."

    def __init__(self, address):
        import zmq
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.REQ)
        self.socket.connect(address)

    def propagate(self, photons):
        self.socket.send_pyobj(photons)
        return self.socket.recv_pyobj()

    def close(self):
        self.socket.close(0)
        self.context.term()
