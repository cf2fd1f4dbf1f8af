"""Device kernels the window launched per second of audio (the profiler's
trace; copies and sets not counted): the host's dispatch load."""

from benchmark.readers import per_unit


def read(run):
    if run.trace_data is None:
        return None
    return per_unit(run.trace_data.kernel_count(), run.units("audio_s"))
