from zerovox_tpu_torch.parallel.mesh import MeshConfig, make_mesh, replicate, shard_batch

__all__ = ["MeshConfig", "make_mesh", "shard_batch", "replicate"]
