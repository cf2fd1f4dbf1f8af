"""Parallelism layer (counterpart of audiolab_tpu/parallel): meshes live in
core/mesh.py; this package holds the sharding rules per model family (the
reference has data parallelism only; tensor parallelism is the mesh axis
for the largest LMs, e.g. YuE's stage 1)."""

from audiolab_tpu_torch.parallel.tp import lm_tp_shardings, shard_lm_params

__all__ = ["lm_tp_shardings", "shard_lm_params"]
