"""device_idle_pct: the share of a step in which no kernel, copy or
memset ran on the card, in %: the device's busy seconds a traced step
over a step's host-clock seconds with the profiler stopped (the same
run's steps after the traced ones), since the profiler stretches the
host's side of a traced step and not the device's work.  Not clamped:
busy time above the step's reads below 0."""


def read(r):
    if not r.ops or not r.steps or not r.step_s:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.steps / r.step_s)
