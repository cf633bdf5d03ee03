"""Morton coding of quantised coordinates, the part of chroma_tpu.bvh.build
that the instanced-table builder (chroma_tpu_torch.bvh.wide) uses."""
from __future__ import annotations

import numpy as np


def spread3_16(x):
    """Spread the low 16 bits of each element so they occupy every third bit
    of the result (Morton interleave helper)."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x00000000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x000000F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x00000C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x0000249249249249)
    return x


def morton_codes_3d(q):
    "48-bit Morton codes from (n,3) quantized 16-bit coordinates."
    return (spread3_16(q[:, 0])
            | (spread3_16(q[:, 1]) << np.uint64(1))
            | (spread3_16(q[:, 2]) << np.uint64(2)))
