from vision_kit_tpu_torch.parallel.distributed import init_distributed
from vision_kit_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, shard_batch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "init_distributed", "make_mesh", "shard_batch"]
