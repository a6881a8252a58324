from flye_tpu_torch.index.kmer_index import KmerIndex


def build_minimizer_index(store, k, w, min_cov=1, repeat_kmer_rate=100,
                          ids=None):
    """Minimizer-index build (single device; the JAX package's
    mesh-sharded build is not yet ported)."""
    return KmerIndex.build_minimizers(
        store, k, w, min_cov=min_cov,
        repeat_kmer_rate=repeat_kmer_rate, ids=ids)


def build_solid_index(store, k, select_rate, tandem_freq,
                      global_min_freq=2, sample=1, repeat_kmer_rate=100,
                      ids=None):
    """Solid-kmer (raw-read) index build (single device; the JAX
    package's mesh-sharded build is not yet ported).  Counting runs on
    the host, or on the runtime's device under FLYE_TPU_DEVICE_COUNT=1
    (`KmerIndex.build_solid`)."""
    return KmerIndex.build_solid(
        store, k, select_rate=select_rate, tandem_freq=tandem_freq,
        global_min_freq=global_min_freq, sample=sample,
        repeat_kmer_rate=repeat_kmer_rate, ids=ids)
