"""driver_idle: the card's idle time while the host's innermost program
span is the fused driver's (chroma.propagate.*: its stages, waits on the
card, compactions and mop-ups) or a graph capture's (chroma.graphs.*), in
percent of the traced window."""
from bench_h100.harness import program


def read(run):
    return program.share(run, ('chroma.propagate.', 'chroma.graphs.'))
