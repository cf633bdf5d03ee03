"""readback_reuse: the share of the window's readbacks to the host that
took their block from the pinned pool without growing it (the program's
counters readback.new_blocks and readback.calls), in percent."""


def read(run):
    counters = run.counters or {}
    calls = counters.get('readback.calls')
    if not calls:
        return None
    return 100.0 * (1 - counters.get('readback.new_blocks', 0) / calls)
