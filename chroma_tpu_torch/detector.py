"""Detector: a Geometry whose PMT solids are wired to DAQ channels
(reference: chroma/detector.py)."""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.geometry import Geometry


class Detector(Geometry):
    """A Geometry where some Solids are photon detectors ("PMTs"), each
    connected to an electronics channel recording a hit time and charge.

    Channel indices are dense, starting at zero, in the order PMTs were
    added; channel ids (channel_type) are arbitrary stable integers.
    All channels currently share one time and one charge distribution,
    stored as CDFs sampled by the DAQ.
    """

    def __init__(self, detector_material=None):
        Geometry.__init__(self, detector_material=detector_material)

        self.solid_id_to_channel_index = []
        self.channel_index_to_solid_id = []
        self.channel_index_to_channel_type = []
        self.channel_index_to_position = []

        # zero-jitter time and unit-charge distributions by default
        self.time_cdf = (np.array([-0.00000001, 0.00000001]),
                         np.array([0.0, 1.0]))
        self.charge_cdf = (np.array([0.999999999, 1.00000000]),
                           np.array([0.0, 1.0]))

    def add_solid(self, solid, rotation=None, displacement=None):
        """Add a non-detecting solid (maps to no channel)."""
        solid_id = Geometry.add_solid(self, solid=solid, rotation=rotation,
                                      displacement=displacement)
        self.solid_id_to_channel_index.append(-1)
        return solid_id

    def add_pmt(self, pmt, rotation=None, displacement=None,
                channel_type=None):
        """Add a PMT solid and assign it the next channel index.

        Returns {'solid_id', 'channel_index', 'channel_type'}.
        """
        solid_id = self.add_solid(solid=pmt, rotation=rotation,
                                  displacement=displacement)

        channel_index = len(self.channel_index_to_solid_id)
        if channel_type is None:
            channel_type = channel_index

        self.solid_id_to_channel_index[solid_id] = channel_index
        self.channel_index_to_solid_id.append(solid_id)
        self.channel_index_to_channel_type.append(channel_type)
        self.channel_index_to_position.append(
            displacement if displacement is not None else np.zeros(3))

        return {'solid_id': solid_id,
                'channel_index': channel_index,
                'channel_type': channel_type}

    @staticmethod
    def _pdf_to_cdf(bin_edges, bin_contents):
        """(cdf_x, cdf_y) for a binned PDF. bin_contents should NOT be
        normalized for bin width."""
        cdf_x = np.copy(bin_edges)
        cdf_y = np.concatenate([[0.0], np.cumsum(bin_contents)])
        cdf_y /= cdf_y[-1]
        return (cdf_x, cdf_y)

    def set_time_dist_gaussian(self, rms, lo, hi, nsamples=50):
        pdf_x = np.linspace(lo, hi, nsamples + 1, endpoint=True)
        pdf_y = np.exp(-0.5 * (pdf_x[1:] / rms) ** 2)
        self.time_cdf = self._pdf_to_cdf(pdf_x, pdf_y)

    def set_time_dist(self, bin_edges, bin_contents):
        """Set the hit-time jitter PDF from a histogram."""
        self.time_cdf = self._pdf_to_cdf(bin_edges, bin_contents)

    def set_charge_dist_gaussian(self, mean, rms, lo, hi, nsamples=50):
        pdf_x = np.linspace(lo, hi, nsamples + 1, endpoint=True)
        pdf_y = np.exp(-0.5 * ((pdf_x[1:] - mean) / rms) ** 2)
        self.charge_cdf = self._pdf_to_cdf(pdf_x, pdf_y)

    def num_channels(self):
        return len(self.channel_index_to_channel_type)

    def flatten(self):
        self.solid_id_to_channel_index = np.asarray(
            self.solid_id_to_channel_index, dtype=np.int32)
        self.channel_index_to_solid_id = np.asarray(
            self.channel_index_to_solid_id, dtype=np.int32)
        self.channel_index_to_channel_type = np.asarray(
            self.channel_index_to_channel_type, dtype=np.int32)
        self.channel_index_to_position = np.asarray(
            self.channel_index_to_position, dtype=np.float32)
        Geometry.flatten(self)
