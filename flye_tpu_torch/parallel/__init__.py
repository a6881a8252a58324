from flye_tpu_torch.parallel.runtime import (ParallelContext, get_runtime,
                                             init_runtime, set_runtime)
