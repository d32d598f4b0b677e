"""Device operations (kernels, copies, sets) a job launched in the traced
window: the engine's dispatch cost, which the host pays for every one."""


def read(view):
    return len(view.trace.ops) / view.jobs if view.jobs and view.trace.ops else None
