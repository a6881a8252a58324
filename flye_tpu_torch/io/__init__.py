from flye_tpu_torch.io.fasta import (
    read_seq_file,
    write_fasta,
    codes_to_str,
    str_to_codes,
)
from flye_tpu_torch.io.seqstore import SeqId, SequenceStore
