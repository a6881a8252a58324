from flye_tpu_torch.index.kmer_index import KmerIndex


def build_minimizer_index(store, k, w, min_cov=1, repeat_kmer_rate=100,
                          ids=None):
    """Minimizer-index build routed through the parallel runtime: on a
    >1-device mesh the index is hash-sharded and built with the posting
    exchange (`ShardedKmerIndex.build_minimizers_mesh`); otherwise the
    plain sorted-array build.  Both hold the same postings per k-mer,
    so the overlaps downstream are the same."""
    from flye_tpu_torch.parallel.runtime import get_runtime

    rt = get_runtime()
    if rt.active:
        from flye_tpu_torch.index.sharded import ShardedKmerIndex
        return ShardedKmerIndex.build_minimizers_mesh(
            store, k, w, rt.mesh, min_cov=min_cov,
            repeat_kmer_rate=repeat_kmer_rate, ids=ids)
    return KmerIndex.build_minimizers(
        store, k, w, min_cov=min_cov,
        repeat_kmer_rate=repeat_kmer_rate, ids=ids)


def build_solid_index(store, k, select_rate, tandem_freq,
                      global_min_freq=2, sample=1, repeat_kmer_rate=100,
                      ids=None):
    """Solid-k-mer (raw-read) index build routed like
    build_minimizer_index: a >1-device mesh hash-shards the selected
    postings with the posting exchange (`ShardedKmerIndex.
    build_solid_mesh`, host counting).  Otherwise counting runs on the
    host, or on the runtime's device under FLYE_TPU_DEVICE_COUNT=1
    (`KmerIndex.build_solid`)."""
    from flye_tpu_torch.parallel.runtime import get_runtime

    rt = get_runtime()
    if rt.active:
        from flye_tpu_torch.index.sharded import ShardedKmerIndex
        return ShardedKmerIndex.build_solid_mesh(
            store, k, rt.mesh, select_rate=select_rate,
            tandem_freq=tandem_freq, global_min_freq=global_min_freq,
            sample=sample, repeat_kmer_rate=repeat_kmer_rate, ids=ids)
    return KmerIndex.build_solid(
        store, k, select_rate=select_rate, tandem_freq=tandem_freq,
        global_min_freq=global_min_freq, sample=sample,
        repeat_kmer_rate=repeat_kmer_rate, ids=ids)
