from flye_tpu_torch.overlap.structs import Overlap
from flye_tpu_torch.overlap.engine import OverlapEngine, OverlapStore
