"""ray_tpu_torch.utils: ids, serialization and the runtime flags the
in-process runtime reads."""
