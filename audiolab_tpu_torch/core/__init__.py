"""Host I/O, chunking, the device rules and meshes of the port."""

from audiolab_tpu_torch.core.mesh import get_mesh, local_mesh

__all__ = ["get_mesh", "local_mesh"]
