"""ray_tpu_torch.core: the in-process runtime (tasks, actors, objects)
behind ``ray_tpu_torch.init``."""
