from flye_tpu_torch.config.params import (
    Config,
    PIPELINE,
    setup_run_params,
)
