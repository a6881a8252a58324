from flye_tpu_torch.assemble.chimera import ChimeraDetector
from flye_tpu_torch.assemble.extender import Extender, ContigPath
from flye_tpu_torch.assemble.driver import assemble_disjointigs
