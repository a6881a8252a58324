from flye_tpu_torch.repeat.graph import (EdgeSequence, GraphEdge,
                                         GraphNode, RepeatGraph)
