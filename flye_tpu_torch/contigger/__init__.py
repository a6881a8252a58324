from flye_tpu_torch.contigger.extender import generate_contigs, ContigInfo
