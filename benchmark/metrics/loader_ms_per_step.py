"""Milliseconds in next() of RVCDataLoader.batches per training step (the
benchmark's span around the call, closed by synchronize)."""

from benchmark.readers import per_unit


def read(run):
    return per_unit(run.span_s("loader"), run.units("steps"), 1000.0)
