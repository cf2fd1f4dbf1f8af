"""PyTorch/CUDA port of audiolab_tpu (separate -> RVC slice)."""
