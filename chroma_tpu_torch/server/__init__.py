"""ZeroMQ photon propagation services of the torch port (counterpart of
chroma_tpu.server; reference: bin/chroma-server, bin/chroma-server-rat).

Cross-node integration stays at the host level exactly like the reference
(SURVEY §5.8): a REQ/REP socket speaking either pickled Photons objects
(PhotonServer) or the packed little-endian binary protocol used by RAT
clients (RatServer). zmq is imported by the constructors, so the modules
import without it."""
from chroma_tpu_torch.server.photon_server import (  # noqa: F401
    PhotonServer, PhotonClient)
from chroma_tpu_torch.server.rat_server import RatServer  # noqa: F401
