"""wire_lane_efficiency: the photon-steps of the window whose ray reaches
a wire plane's slab before its mesh hit (the reference's count, scaled to
the window's photons) over the lanes K3 walked (the program's counter
wire.walked: steps x launched width on a geometry with wire planes), in
percent."""


def read(run):
    walked = (run.counters or {}).get('wire.walked')
    per = (run.facts or {}).get('wire_steps_per_photon')
    if not walked or per is None:
        return None
    return 100.0 * per * sum(c['photons'] for c in run.calls) / walked
