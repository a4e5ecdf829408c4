from ganon_tpu_torch.parallel.mesh import make_mesh, ShardedClassifier

__all__ = ["make_mesh", "ShardedClassifier"]
