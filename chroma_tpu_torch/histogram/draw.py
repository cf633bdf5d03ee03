"""Matplotlib drawing helpers (reference: chroma/histogram/draw.py)."""
from __future__ import annotations

import numpy as np


def draw(obj, **kwargs):
    "Draw a Histogram or Graph with matplotlib; returns the axes."
    import matplotlib.pyplot as plt
    from chroma_tpu_torch.histogram.histogram import Histogram
    from chroma_tpu_torch.histogram.graph import Graph

    ax = kwargs.pop('ax', None) or plt.gca()
    if isinstance(obj, Histogram):
        ax.step(np.repeat(obj.bins, 2)[1:-1], np.repeat(obj.hist, 2),
                **kwargs)
    elif isinstance(obj, Graph):
        ax.errorbar(obj.x, obj.y, xerr=obj.xerr, yerr=obj.yerr,
                    fmt='.', **kwargs)
    else:
        raise TypeError('cannot draw %r' % type(obj))
    return ax
