"""Seconds from the start of the process to the first timed item: building
and filling the models, making the traffic, warming every shape the cell
uses (and, in a checkout's first run, building the CUDA kernels).  The
seconds the plain reference spends making an input of the cell (the
chain's retrieval index) are left out: they are the reference's."""


def read(run):
    return run.setup_s
