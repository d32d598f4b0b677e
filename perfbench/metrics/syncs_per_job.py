"""Device-to-host copies a job made in the traced window: the trace's
`Memcpy DtoH` operations (CUPTI's records, not the program's spans) over its
jobs. The port makes each one as a blocking read (`.cpu()`, `.item()`,
`.tolist()`): it drains the device's queue and leaves the device idle until
the host enqueues again. An exact count."""
D2H = "Memcpy DtoH"


def read(view):
    if not view.jobs or not view.trace.ops:
        return None
    return sum(1 for name, _, _ in view.trace.ops if name.startswith(D2H)) / view.jobs
