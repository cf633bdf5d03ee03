"""GDML geometry import (reference: chroma/gdml/)."""
from chroma_tpu_torch.gdml.loader import GDMLLoader, Volume  # noqa: F401
