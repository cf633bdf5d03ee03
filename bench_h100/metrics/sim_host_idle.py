"""sim_host_idle: the card's idle time while the host's innermost program
span is the Simulation facade's (chroma.sim.*: upload, the readback and
its channels, each event's host work, the facade's Python around the
driver and the DAQ), in percent of the traced window."""
from bench_h100.harness import program


def read(run):
    return program.share(run, ('chroma.sim.',))
