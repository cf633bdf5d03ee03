"""daq_idle: the card's idle time while the host's innermost program span
is the DAQ's (chroma.daq.*: run_daq and its blocks of draws, the flat
hits, the channels' copy to the host), in percent of the traced window."""
from bench_h100.harness import program


def read(run):
    return program.share(run, ('chroma.daq.',))
