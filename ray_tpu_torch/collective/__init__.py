"""ray_tpu_torch.collective: the int8 wire format of the quantized
cross-slice gradient stage (``quant``)."""
