"""steps_per_event: the driver's steps (the program's counter
propagate.steps, every stage and mop-up) over the window's events."""


def read(run):
    steps = (run.counters or {}).get("propagate.steps")
    if not steps:
        return None
    return steps / len(run.calls)
