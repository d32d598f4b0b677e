"""The share of the jobs' wall time in which no device operation ran, in %:
1 - the device's busy time in the traced pass (the union of the operations'
intervals) / the seconds of the same jobs run without the profiler, which
stretches the host's side of a job and not the device's."""


def read(view):
    if not view.trace.ops or not view.untraced_s:
        return None
    return 100.0 * (1.0 - view.trace.busy_us() * 1e-6 / view.untraced_s)
