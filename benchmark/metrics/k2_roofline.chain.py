"""K2 (kernels/attention.py::flash_attention_fwd) in the chain's HuBERT,
fp32, against its roofline: fp32 products at the fp32 peak (67 TFLOP/s on
the H100 SXM), bytes at the HBM bandwidth, over the device time of the K2
kernels (the profiler's trace)."""

from benchmark.readers import roofline_share


def read(run):
    return roofline_share(run, "K2", ("k2f_kernel", "k2h_kernel", "k2_kernel"),
                          "fp32_flops_per_s")
