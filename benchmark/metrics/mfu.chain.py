"""The chain's model FLOPs (work/flops.py: the reference's products on the
window's songs) over the traced window's seconds over the card's bf16 peak,
the precision of the configuration's products."""

from benchmark.readers import mfu


def read(run):
    return mfu(run, "bf16_flops_per_s")
