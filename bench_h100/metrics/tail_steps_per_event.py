"""tail_steps_per_event: the driver's steps that no compaction follows
(the program's counter propagate.tail_steps: the last stage's steps and
the mop-ups') over the window's events."""


def read(run):
    tail = (run.counters or {}).get("propagate.tail_steps")
    if tail is None or not run.calls:
        return None
    return tail / len(run.calls)
