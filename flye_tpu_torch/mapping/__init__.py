from flye_tpu_torch.mapping.mapper import ReadMapper
