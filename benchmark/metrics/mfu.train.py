"""The training step's model FLOPs (work/flops.py: the reference's forward
and backward products at the window's batch) over the traced window's
seconds over the card's fp32 peak (the step runs fp32 with TF32 off)."""

from benchmark.readers import mfu


def read(run):
    return mfu(run, "fp32_flops_per_s")
