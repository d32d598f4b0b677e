"""Device milliseconds a job spent inside the engine's `engine.clean` stage
programs (utils/profiling.stage_range), from the traced window."""


def read(view):
    return view.stage_ms_per_job("clean")
