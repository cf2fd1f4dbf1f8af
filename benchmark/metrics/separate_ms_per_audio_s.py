"""Milliseconds in StemSeparator.separate per second of audio (the
benchmark's span around the call, closed by synchronize)."""

from benchmark.readers import per_unit


def read(run):
    return per_unit(run.span_s("separate"), run.units("audio_s"), 1000.0)
