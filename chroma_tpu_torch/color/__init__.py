"""Color utilities for visualization (reference: chroma/color/)."""
from chroma_tpu_torch.color.chromaticity import map_wavelength  # noqa: F401
from chroma_tpu_torch.color.colormap import map_to_color  # noqa: F401
