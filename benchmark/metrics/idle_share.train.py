"""Share of the training window in which no kernel, copy or set ran on the
device."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
