"""Event and geometry I/O of the torch port (counterpart of chroma_tpu.io).

The native event format is the portable zip-of-npz event file, shared with
chroma_tpu; chroma_tpu_torch.io.root provides the PyROOT bridge with the
reference's reader/writer API when ROOT is installed, and
chroma_tpu_torch.io.geocache the device-ready geometry cache in
chroma_tpu's file layout."""
from chroma_tpu_torch.io.npz import EventWriter, EventReader  # noqa: F401
