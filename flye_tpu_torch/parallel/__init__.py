from flye_tpu_torch.parallel.distributed import (host_partition,
                                                 init_distributed,
                                                 is_coordinator)
from flye_tpu_torch.parallel.mesh import (make_mesh, posting_exchange_step,
                                          sharded_pipeline_step)
from flye_tpu_torch.parallel.runtime import (ParallelContext, get_runtime,
                                             init_runtime, set_runtime)
