"""Milliseconds in the device resample and VoiceConverter.convert per second
of audio (the benchmark's span around the calls, closed by synchronize)."""

from benchmark.readers import per_unit


def read(run):
    return per_unit(run.span_s("convert"), run.units("audio_s"), 1000.0)
