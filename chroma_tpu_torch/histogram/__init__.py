"""Histogramming (reference: chroma/histogram/)."""
from chroma_tpu_torch.histogram.histogram import Histogram  # noqa: F401
from chroma_tpu_torch.histogram.histogramdd import HistogramDD  # noqa: F401
from chroma_tpu_torch.histogram.graph import Graph  # noqa: F401
