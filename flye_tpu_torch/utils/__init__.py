from flye_tpu_torch.utils.logs import configure_logging, human_bytes
