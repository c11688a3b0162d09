"""ray_tpu_torch.util: the application metrics API (``util.metrics``)."""
