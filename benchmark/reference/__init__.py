"""The plain references of the benchmark's configurations: fp32 PyTorch
with TF32 off, plain attention, no kernel and nothing of the program.
Shared modules live here; each configuration's entry point is
``<config>/reference.py``."""
