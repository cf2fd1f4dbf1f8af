"""K1 (kernels/attention.py::attention_nk1, csrc/attention.cu) against its
roofline: the least time of the window's K1 calls (bf16 products at the
16-bit peak, bytes at the HBM bandwidth) over the device time of the
kernels k1_route can pick (the profiler's trace)."""

from benchmark.readers import roofline_share


def read(run):
    return roofline_share(run, "K1", ("k1h_time_kernel", "k1h_band_kernel", "k1_kernel"),
                          "bf16_flops_per_s")
