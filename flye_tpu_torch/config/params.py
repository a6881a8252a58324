"""Parameter system for the assembly pipeline.

The reference splits configuration across three layers — CLI flags, Python
constants (reference: flye/config/py_cfg.py), and a float key/value store
loaded from per-read-type .cfg files (reference: src/common/config.h:36-96,
flye/config/bin_cfg/*.cfg).  Here all of it lives in typed Python dicts:
`ASSEMBLY_DEFAULTS` carries the ~45 algorithm tunables, `READ_TYPE_OVERLAYS`
the per-platform overrides (raw / corrected / hifi / subasm), and `PIPELINE`
the stage-level constants.  `Config` resolves overlay -> defaults -> extra
overrides (the `--extra-params k=v,...` analog).

Values mirror the reference's published parameter sets so that outputs are
comparable (reference: flye/config/bin_cfg/asm_defaults.cfg,
asm_raw_reads.cfg:8-10, asm_hifi.cfg:8-11, asm_subasm.cfg:8-10).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger("flye_tpu_torch")


# Algorithm tunables shared by every read type.
ASSEMBLY_DEFAULTS: Dict[str, float] = {
    # index construction
    "big_genome_threshold": 29_000_000,
    "meta_read_filter_kmer_freq": 100,
    # read/disjointig assembly
    "max_coverage_drop_rate": 5,
    "max_extensions_drop_rate": 5,
    "chimera_window": 100,
    "min_reads_in_disjointig": 4,
    "max_inner_reads": 10,
    "max_inner_fraction": 0.25,
    # repeat graph
    "max_separation": 500,
    "unique_edge_length": 50_000,
    "min_repeat_res_support": 0.51,
    "out_paths_ratio": 5,
    "graph_cov_drop_rate": 5,
    "coverage_estimate_window": 100,
    "max_bubble_length": 50_000,
    "loop_coverage_rate": 1.5,
    "repeat_edge_cov_mult": 1.75,
    "weak_detach_rate": 5,
    "tip_coverage_rate": 2,
    "tip_length_rate": 2,
}

# Per-read-type overlays (key parameter deltas between platforms).
READ_TYPE_OVERLAYS: Dict[str, Dict[str, float]] = {
    "raw": {
        "low_cutoff_warning": 1,
        "hard_min_coverage_rate": 10,
        "kmer_size": 17,
        "use_minimizers": 0,
        "minimizer_window": 1,
        "reads_base_alignment": 0,
        "assemble_kmer_sample": 1,
        "repeat_graph_kmer_sample": 1,
        "read_align_kmer_sample": 1,
        "meta_read_top_kmer_rate": 0.40,
        "maximum_jump": 1500,
        "maximum_overhang": 1500,
        "repeat_kmer_rate": 100,
        "assemble_ovlp_divergence": 0.10,
        "assemble_divergence_relative": 1,
        # maxCurOverlaps economy: cap per-read overlap collection at
        # factor * expected coverage during ava (0 = off, matching the
        # reference release where the cap is compiled out —
        # reference: src/assemble/main_assemble.cpp:228,
        # src/sequence/overlap.cpp:218-219)
        "max_read_overlaps_factor": 0,
        "repeat_graph_ovlp_divergence": 0.10,
        "read_align_ovlp_divergence": 0.25,
        "hpc_scoring_on": 0,
        "add_unassembled_reads": 0,
        "extend_contigs_with_repeats": 0,
        "min_read_cov_cutoff": 3,
        "short_tip_length": 20_000,
        "long_tip_length": 100_000,
    },
    "corrected": {
        "low_cutoff_warning": 0,
        "hard_min_coverage_rate": 50,
        "kmer_size": 17,
        "use_minimizers": 1,
        "minimizer_window": 5,
        "reads_base_alignment": 1,
        "assemble_kmer_sample": 2,
        "repeat_graph_kmer_sample": 2,
        "read_align_kmer_sample": 2,
        "meta_read_top_kmer_rate": 0.75,
        "maximum_jump": 1500,
        "maximum_overhang": 500,
        "repeat_kmer_rate": 100,
        "assemble_ovlp_divergence": 0.03,
        "assemble_divergence_relative": 0,
        "repeat_graph_ovlp_divergence": 0.03,
        "read_align_ovlp_divergence": 0.03,
        "hpc_scoring_on": 0,
        "add_unassembled_reads": 0,
        "extend_contigs_with_repeats": 0,
        "min_read_cov_cutoff": 3,
        "short_tip_length": 10_000,
        "long_tip_length": 100_000,
    },
    "hifi": {
        "low_cutoff_warning": 0,
        "hard_min_coverage_rate": 50,
        "kmer_size": 17,
        "use_minimizers": 1,
        "minimizer_window": 10,
        "reads_base_alignment": 1,
        "assemble_kmer_sample": 2,
        "repeat_graph_kmer_sample": 2,
        "read_align_kmer_sample": 2,
        "meta_read_top_kmer_rate": 0.75,
        "maximum_jump": 1500,
        "maximum_overhang": 500,
        "repeat_kmer_rate": 100,
        "assemble_ovlp_divergence": 0.01,
        "assemble_divergence_relative": 0,
        "repeat_graph_ovlp_divergence": 0.01,
        "read_align_ovlp_divergence": 0.03,
        "hpc_scoring_on": 1,
        "add_unassembled_reads": 0,
        "extend_contigs_with_repeats": 0,
        "min_read_cov_cutoff": 3,
        "short_tip_length": 10_000,
        "long_tip_length": 100_000,
    },
    "subasm": {
        "low_cutoff_warning": 0,
        "hard_min_coverage_rate": 50,
        "kmer_size": 31,
        "use_minimizers": 1,
        "minimizer_window": 10,
        "reads_base_alignment": 1,
        "assemble_kmer_sample": 2,
        "repeat_graph_kmer_sample": 2,
        "read_align_kmer_sample": 2,
        "meta_read_top_kmer_rate": 0.75,
        "maximum_jump": 500,
        "maximum_overhang": 100,
        "repeat_kmer_rate": 100,
        "assemble_ovlp_divergence": 0.02,
        "assemble_divergence_relative": 0,
        "repeat_graph_ovlp_divergence": 0.02,
        "read_align_ovlp_divergence": 0.02,
        "hpc_scoring_on": 0,
        "add_unassembled_reads": 1,
        "extend_contigs_with_repeats": 0,
        "min_read_cov_cutoff": 1,
        "short_tip_length": 10_000,
        "long_tip_length": 100_000,
    },
}

# Stage-level constants (reference: flye/config/py_cfg.py:12-71).
PIPELINE: Dict[str, object] = {
    "pipeline_version": 3,
    "min_overlap_range": {
        "raw": (1000, 5000),
        "corrected": (1000, 5000),
        "hifi": (1000, 5000),
        "subasm": (1000, 1000),
    },
    "max_meta_overlap": 3000,
    # polishing
    "simple_kmer_length": 4,
    "solid_kmer_length": 10,
    "max_bubble_length": 500,
    "max_bubble_branches": 50,
    "max_read_coverage": 1000,
    "min_polish_aln_len": 500,
    # final coverage filtering
    "relative_minimum_coverage": 5,
    "hard_minimum_coverage": 3,
    "err_modes": {
        "pacbio": {
            "subs_matrix": "pacbio_substitutions",
            "hopo_matrix": "pacbio_homopolymers",
            "solid_missmatch": 0.2,
            "solid_indel": 0.2,
            "max_aln_error": 0.25,
        },
        "nano": {
            "subs_matrix": "nano_r94_substitutions",
            "hopo_matrix": "nano_r94_homopolymers",
            "solid_missmatch": 0.3,
            "solid_indel": 0.3,
            "max_aln_error": 0.25,
        },
        # legacy R7 pore chemistry (reference: flye/config/py_cfg.py
        # ships nano_r7_substitutions.mat alongside r94)
        "nano_r7": {
            "subs_matrix": "nano_r7_substitutions",
            "hopo_matrix": "nano_r7_homopolymers",
            "solid_missmatch": 0.3,
            "solid_indel": 0.3,
            "max_aln_error": 0.25,
        },
    },
    "scaffold_gap": 100,
}


class Config:
    """Resolved parameter set for one run.

    Lookup order: extra overrides > read-type overlay > defaults. Exposes
    both mapping (`cfg["kmer_size"]`) and attribute (`cfg.kmer_size`)
    access; ints are returned as ints when the stored value is integral.
    """

    def __init__(
        self,
        read_type: str = "raw",
        extra_params: Optional[str] = None,
        **runtime: float,
    ):
        if read_type not in READ_TYPE_OVERLAYS:
            raise ValueError(f"unknown read type: {read_type}")
        self.read_type = read_type
        self._values: Dict[str, float] = dict(ASSEMBLY_DEFAULTS)
        self._values.update(READ_TYPE_OVERLAYS[read_type])
        # runtime parameters (reference: src/common/config.h:103-115
        # Parameters singleton: kmerSize / minimumOverlap / numThreads /
        # unevenCoverage)
        self._values.setdefault("min_overlap", 5000)
        self._values.setdefault("uneven_coverage", 0)  # --meta mode
        self._values.update(runtime)
        if extra_params:
            self.apply_extra(extra_params)

    def apply_extra(self, extra_params: str) -> None:
        for tok in extra_params.split(","):
            tok = tok.strip()
            if not tok:
                continue
            key, _, val = tok.partition("=")
            if not _:
                raise ValueError(f"malformed extra param: {tok!r}")
            self._values[key.strip()] = float(val)
            logger.debug("extra param override: %s=%s", key, val)

    def __getitem__(self, key: str):
        v = self._values[key]
        if isinstance(v, float) and v.is_integer():
            return int(v)
        return v

    def __getattr__(self, key: str):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def set(self, key: str, value: float) -> None:
        self._values[key] = value

    def as_dict(self) -> Dict[str, float]:
        return dict(self._values)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"read_type": self.read_type, "values": self._values}, f,
                      indent=1)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            blob = json.load(f)
        cfg = cls(blob["read_type"])
        cfg._values.update(blob["values"])
        return cfg

    @classmethod
    def from_cfg(cls, path: str, read_type: str = "raw",
                 extra_params: Optional[str] = None,
                 **runtime: float) -> "Config":
        """Build a Config from a reference-format .cfg file, layered
        over the built-in defaults (so reference bin_cfg files can be
        reused verbatim, including their `%include` chains)."""
        cfg = cls(read_type, **runtime)
        cfg._values.update(load_cfg_file(path))
        if extra_params:
            cfg.apply_extra(extra_params)
        return cfg


def load_cfg_file(path: str) -> Dict[str, float]:
    """Parse a reference-format config file: `key = value` float pairs,
    '#' comment lines, and `%include other.cfg` resolved relative to the
    including file (reference: src/common/config.h:36-72)."""
    values: Dict[str, float] = {}
    dirname = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("%include"):
                inc = line.split(None, 1)[1].strip()
                values.update(load_cfg_file(os.path.join(dirname, inc)))
                continue
            key, sep, val = line.partition("=")
            if not sep:
                raise ValueError(f"bad config line in {path}: {line!r}")
            values[key.strip()] = float(val.strip())
    return values


def setup_run_params(
    read_lengths: Sequence[int],
    read_type: str,
    genome_size: Optional[int] = None,
    min_overlap: Optional[int] = None,
    asm_coverage: Optional[int] = None,
    meta: bool = False,
) -> Dict[str, int]:
    """Auto-select min_overlap (from reads N90, rounded to 1kb, clamped to
    the per-read-type range) and the --asm-coverage downsampling length
    cutoff (reference: flye/config/configurator.py:51-81)."""
    lengths = np.asarray(sorted(read_lengths, reverse=True), dtype=np.int64)
    total = int(lengths.sum()) if len(lengths) else 0
    csum = np.cumsum(lengths) if len(lengths) else np.zeros(0, dtype=np.int64)

    def _nx(rate: float) -> int:
        if total == 0:
            return 0
        pos = np.searchsorted(csum, rate * total, side="right")
        return int(lengths[min(pos, len(lengths) - 1)])

    n50, n90 = _nx(0.50), _nx(0.90)
    logger.info("Total read length: %d", total)
    if genome_size:
        coverage = total // genome_size
        logger.info("Estimated coverage: %d", coverage)
        if coverage < 5 or coverage > 1000:
            logger.warning(
                "Expected read coverage is %d; assembly may be suboptimal. "
                "Was the genome size entered correctly?", coverage)
    logger.info("Reads N50/N90: %d / %d", n50, n90)

    params: Dict[str, int] = {"pipeline_version": int(PIPELINE["pipeline_version"])}
    if min_overlap is None:
        grade = 1000
        lo, hi = PIPELINE["min_overlap_range"][read_type]
        if meta:
            hi = min(hi, PIPELINE["max_meta_overlap"])
        params["min_overlap"] = max(lo, min(hi, int(round(n90 / grade)) * grade))
        logger.info("Minimum overlap set to %d", params["min_overlap"])
    else:
        params["min_overlap"] = min_overlap

    params["min_read_length"] = 0
    if asm_coverage and genome_size and total // genome_size > asm_coverage:
        target_len = genome_size * asm_coverage
        pos = np.searchsorted(csum, target_len, side="right")
        if pos < len(lengths):
            params["min_read_length"] = int(lengths[pos])
        logger.info("Using longest %dx reads for contig assembly "
                    "(length cutoff %d)", asm_coverage, params["min_read_length"])
    return params
