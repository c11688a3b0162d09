"""ray_tpu_torch.parallel: device meshes over ``torch.distributed`` ranks
(``mesh``) and the logical-axis sharding rules (``sharding``)."""
