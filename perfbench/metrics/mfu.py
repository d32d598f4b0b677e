"""The traced jobs' model FLOPs (the benchmark's own count, perfbench/work.py)
over the seconds the same jobs took without the profiler at the card's dense
TF32 peak, in %: no float32 product runs faster than that."""


def read(view):
    if view.peaks is None or not view.flops or not view.untraced_s:
        return None
    return 100.0 * view.flops / (view.untraced_s * view.peaks["tf32_flops"])
