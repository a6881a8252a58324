"""flye_tpu_torch command-line interface and stage pipeline.

Port of `flye_tpu/main.py` (behavioral port of the reference CLI and
Job framework, flye/main.py): the same parser, output layout
(00-assembly ... 40-polishing + the final assembly files) and
job-granular resume via params.json.  The default raw pipeline is
ported: configure -> assembly -> consensus -> repeat -> contigger ->
polishing -> finalize, for every read type, and so is the standalone
polisher (`--polish-target`), and so are the optional stages Trestle
(`--trestle`, between repeat and contigger) and short-plasmid recovery
(`--plasmids`, between contigger and polishing).  `--profile` writes a
torch.profiler trace of the pipeline under OUT_DIR/profile.

N processes of one host run one assembly when `RANK` / `WORLD_SIZE` are
set (`torchrun --standalone --nproc-per-node N -m flye_tpu_torch.main
...` sets them): every process computes the overlaps of its read
partition, process 0 (the coordinator) merges the workers' shards and
runs the later stages, and the workers serve its read-mapping and
bubble-polishing tasks over a file bus in OUT_DIR/.taskbus until it
finishes.  With FLYE_TPU_PARTITIONED=1 such a run partitions the k-mer
index by hash instead: each process builds and holds only its shard,
and the all-vs-all probes go through files in OUT_DIR/00-assembly/
.partition (`parallel/partitioned.py`).  `--shards N` builds a mesh of
the first N visible devices of `--device` (one CPU for `--device cpu`)
in each process: with more than one device the indexes are
hash-sharded over it and the batched kernels split their rows
(`parallel/runtime.py`).  Without it the mesh is one device: a split
over distinct cards has not been run yet.

Usage:
    python -m flye_tpu_torch.main --pacbio-raw reads.fasta -o out_dir \
        -g 1m --device cuda
    python -m flye_tpu_torch.main --pacbio-raw reads.fasta -o out_dir \
        -g 1m --trestle --plasmids --device cuda
    python -m flye_tpu_torch.main --polish-target draft.fasta \
        --pacbio-hifi reads.fasta -o out_dir -i 2 --device cuda
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil
import sys
from typing import Dict, List, Optional

import numpy as np

from flye_tpu_torch.config import Config, PIPELINE, setup_run_params
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.utils import trace
from flye_tpu_torch.utils.logs import configure_logging

logger = logging.getLogger("flye_tpu_torch")

READ_TYPE_FLAGS = {
    # flag -> (platform, read_type)
    "pacbio_raw": ("pacbio", "raw"),
    "pacbio_corr": ("pacbio", "corrected"),
    "pacbio_hifi": ("pacbio", "hifi"),
    "nano_raw": ("nano", "raw"),
    "nano_corr": ("nano", "corrected"),
    "subassemblies": ("pacbio", "subasm"),
}


class PipelineException(Exception):
    pass


class Job:
    """A resumable pipeline stage (reference: flye/main.py:43-83)."""

    name = "job"

    def __init__(self, ctx: "RunContext"):
        self.ctx = ctx
        self.out_files: Dict[str, str] = {}

    def run(self) -> None:
        raise NotImplementedError

    def load_state(self) -> None:
        """Rebuild this stage's in-memory context from its on-disk
        outputs; called instead of run() for stages skipped by
        --resume/--resume-from (reference resumes the same way: later
        stages reload earlier stages' files, flye/main.py:539-576)."""

    def completed(self) -> bool:
        return all(os.path.exists(p) for p in self.out_files.values())

    def save_checkpoint(self) -> None:
        state = {
            "stage_name": self.name,
            "pipeline_version": PIPELINE["pipeline_version"],
            "min_overlap": self.ctx.min_overlap,
            "min_read_length": self.ctx.min_read_length,
        }
        with open(self.ctx.params_file, "w") as f:
            json.dump(state, f, indent=1)


class RunContext:
    def __init__(self, args):
        self.args = args
        self.out_dir = args.out_dir
        self.params_file = os.path.join(self.out_dir, "params.json")
        self.platform, self.read_type = None, None
        for flag, (platform, rtype) in READ_TYPE_FLAGS.items():
            if getattr(args, flag, None):
                self.platform, self.read_type = platform, rtype
                self.reads_files = getattr(args, flag)
        # legacy R7 pore error model (reference ships both r94 and r7
        # matrices, flye/config/py_cfg.py:52-67)
        if (self.platform == "nano" and
                getattr(args, "nano_model", "r94") == "r7"):
            self.platform = "nano_r7"
        self.cfg: Optional[Config] = None
        self.min_overlap = args.min_overlap or 0
        self.min_read_length = 0
        self.reads: Optional[SequenceStore] = None
        self.genome_size = args.genome_size

    def subdir(self, name: str) -> str:
        path = os.path.join(self.out_dir, name)
        os.makedirs(path, exist_ok=True)
        return path

    def load_reads(self) -> SequenceStore:
        if self.reads is None:
            with trace.span("reads: load"):
                self.reads = SequenceStore.from_files(self.reads_files)
            trace.count("reads.count", len(self.reads))
            trace.count("reads.bases", int(self.reads.total_length))
            logger.info("Loaded %d reads, %d total bases",
                        len(self.reads), self.reads.total_length)
        return self.reads


class JobConfigure(Job):
    name = "configure"

    def __init__(self, ctx):
        super().__init__(ctx)

    def run(self):
        reads = self.ctx.load_reads()
        params = setup_run_params(
            [reads.length(i) for i in reads.ids()],
            self.ctx.read_type,
            genome_size=self.ctx.genome_size,
            min_overlap=self.ctx.args.min_overlap,
            asm_coverage=self.ctx.args.asm_coverage,
            meta=self.ctx.args.meta)
        self.ctx.min_overlap = params["min_overlap"]
        self.ctx.min_read_length = params["min_read_length"]
        common = dict(
            extra_params=self.ctx.args.extra_params,
            min_overlap=self.ctx.min_overlap,
            uneven_coverage=int(self.ctx.args.meta),
            keep_haplotypes=int(self.ctx.args.keep_haplotypes))
        if getattr(self.ctx.args, "config", None):
            self.ctx.cfg = Config.from_cfg(
                self.ctx.args.config, self.ctx.read_type, **common)
        else:
            self.ctx.cfg = Config(self.ctx.read_type, **common)


class JobAssembly(Job):
    name = "assembly"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.out_files["assembly"] = os.path.join(
            ctx.subdir("00-assembly"), "draft_assembly.fasta")

    def run(self):
        from flye_tpu_torch.assemble import assemble_disjointigs
        reads = self.ctx.load_reads()
        if self.ctx.min_read_length:
            filtered = SequenceStore()
            for sid in reads.ids():
                if reads.length(sid) >= self.ctx.min_read_length:
                    filtered.add(reads.name(sid), reads.get(sid))
            reads = filtered
        disjointigs = assemble_disjointigs(
            reads, self.ctx.cfg, self.ctx.min_overlap,
            self.ctx.genome_size,
            work_dir=self.ctx.subdir("00-assembly"))
        if disjointigs is None:
            return  # multi-process worker: shard contributed, done
        if not disjointigs:
            raise PipelineException(
                "No disjointigs were assembled - please check if the "
                "read type and genome size parameters are correct")
        write_fasta(disjointigs, self.out_files["assembly"])


class JobConsensus(Job):
    name = "consensus"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.out_files["consensus"] = os.path.join(
            ctx.subdir("10-consensus"), "consensus.fasta")

    def run(self):
        from flye_tpu_torch.polishing.polisher import polish
        reads = self.ctx.load_reads()
        drafts = SequenceStore.from_file(
            os.path.join(self.ctx.out_dir, "00-assembly",
                         "draft_assembly.fasta"))
        pairs = [(drafts.name(i), drafts.get(i)) for i in drafts.ids()]
        mb = (self.ctx.cfg.polish_max_bubble
              if "polish_max_bubble" in self.ctx.cfg else None)
        consensus = polish(pairs, reads, self.ctx.platform, num_iters=1,
                           max_bubble=mb, trim_ends=True)
        consensus = [(n, s) for n, s in consensus if len(s)]
        write_fasta(consensus, self.out_files["consensus"])


class JobRepeat(Job):
    name = "repeat"

    def __init__(self, ctx):
        super().__init__(ctx)
        d = ctx.subdir("20-repeat")
        self.out_files["graph"] = os.path.join(d, "repeat_graph_dump")
        self.out_files["alignment"] = os.path.join(
            d, "read_alignment_dump")

    def run(self):
        from flye_tpu_torch.repeat.driver import analyse_repeats
        reads = self.ctx.load_reads()
        disjointigs = SequenceStore.from_file(
            os.path.join(self.ctx.out_dir, "10-consensus",
                         "consensus.fasta"))
        graph, aligner, inferer = analyse_repeats(
            disjointigs, reads, self.ctx.cfg,
            out_dir=self.ctx.subdir("20-repeat"),
            min_overlap=self.ctx.min_overlap)
        self.ctx.repeat_state = (graph, aligner, inferer)


def _load_repeat_dumps(ctx):
    """Reload (graph, aligner) from stage dumps on resume; prefers
    Trestle's updated graph dump (25-trestle) over the repeat stage's
    when present, as the JAX package does (the reference's precedence,
    flye/main.py:375-415)."""
    from flye_tpu_torch.repeat.graph import RepeatGraph
    from flye_tpu_torch.repeat.read_aligner import ReadAligner
    reads = ctx.load_reads()
    disjointigs = SequenceStore.from_file(
        os.path.join(ctx.out_dir, "10-consensus", "consensus.fasta"))
    d = os.path.join(ctx.out_dir, "20-repeat")
    graph_dump = os.path.join(ctx.out_dir, "25-trestle",
                              "repeat_graph_dump")
    if not os.path.exists(graph_dump):
        graph_dump = os.path.join(d, "repeat_graph_dump")
    graph = RepeatGraph.load(disjointigs, graph_dump)
    aligner = ReadAligner.load(
        graph, reads, ctx.cfg, ctx.min_overlap,
        os.path.join(d, "read_alignment_dump"))
    return graph, aligner


def _graph_mean_coverage(graph) -> int:
    """Length-weighted mean edge coverage recomputed from a loaded
    graph dump (stands in for MultiplicityInferer.mean_coverage on
    resume; reference estimates it from alignments the same way,
    multiplicity_inferer.cpp:14-90)."""
    num = den = 0
    for edge in graph.edges.values():
        if edge.mean_coverage > 0 and edge.length() > 0:
            num += edge.mean_coverage * edge.length()
            den += edge.length()
    return max(1, int(num / den)) if den else 1


class JobTrestle(Job):
    """Unbridged-repeat resolution.  File contract mirrors the
    reference (flye/main.py:375-415): consumes the 20-repeat dumps,
    writes an updated repeat_graph_dump into its own directory which
    the contigger then prefers over the 20-repeat one."""

    name = "trestle"

    def __init__(self, ctx):
        super().__init__(ctx)
        d = ctx.subdir("25-trestle")
        self.out_files["graph"] = os.path.join(d, "repeat_graph_dump")

    def run(self):
        from flye_tpu_torch.trestle import resolve_unbridged_repeats
        reads = self.ctx.load_reads()
        state = getattr(self.ctx, "repeat_state", None)
        if state is None:  # resume: reload from the repeat-stage dumps
            graph, aligner = _load_repeat_dumps(self.ctx)
            mean_cov = _graph_mean_coverage(graph)
            self.ctx.repeat_state = (graph, aligner, None)
        else:
            graph, aligner, inferer = state
            mean_cov = (inferer.mean_coverage if inferer is not None
                        else _graph_mean_coverage(graph))
        resolve_unbridged_repeats(graph, reads, aligner, mean_cov)
        graph.store(self.out_files["graph"])


class JobContigger(Job):
    name = "contigger"

    def __init__(self, ctx):
        super().__init__(ctx)
        d = ctx.subdir("30-contigger")
        self.out_files["contigs"] = os.path.join(d, "contigs.fasta")
        self.out_files["stats"] = os.path.join(d, "contigs_stats.txt")
        self.out_files["gfa"] = os.path.join(d, "graph_final.gfa")

    def run(self):
        from flye_tpu_torch.contigger import generate_contigs
        state = getattr(self.ctx, "repeat_state", None)
        if state is None:
            # resume: reload the graph and alignments from the repeat
            # stage dumps (Trestle's updated graph wins if present)
            graph, aligner = _load_repeat_dumps(self.ctx)
        else:
            graph, aligner, _ = state
        contigs, links = generate_contigs(
            graph, aligner, self.ctx.cfg,
            out_dir=self.ctx.subdir("30-contigger"))
        self.ctx.contigs = contigs
        self.ctx.links = links

    def load_state(self):
        """Rebuild ctx.contigs/ctx.links from the stage's files."""
        from flye_tpu_torch.contigger.extender import ContigInfo
        store = SequenceStore.from_file(self.out_files["contigs"])
        by_name = {store.name(i): store.get(i) for i in store.ids()}
        contigs = []
        with open(self.out_files["stats"]) as f:
            next(f)  # header
            for line in f:
                (name, length, cov, circ, rep, mult, alt,
                 path) = line.rstrip("\n").split("\t")
                seq = by_name.get(name)
                if seq is None:
                    continue
                contigs.append(ContigInfo(
                    name=name, sequence=seq, length=int(length),
                    coverage=int(cov), circular=circ == "Y",
                    repetitive=rep == "Y", multiplicity=int(mult),
                    alt_group=(-1 if alt == "*" else int(alt)),
                    graph_path=path))
        links = []
        links_file = os.path.join(self.ctx.subdir("30-contigger"),
                                  "scaffolds_links.txt")
        if os.path.exists(links_file):
            with open(links_file) as f:
                for line in f:
                    a, b = line.rstrip("\n").split("\t")
                    links.append((a, b))
        self.ctx.contigs = contigs
        self.ctx.links = links


class JobPlasmids(Job):
    name = "plasmids"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.out_files["plasmids"] = os.path.join(
            ctx.subdir("22-plasmids"), "plasmids.fasta")

    def run(self):
        from flye_tpu_torch.plasmids import recover_short_plasmids
        reads = self.ctx.load_reads()
        contigs_store = SequenceStore.from_file(
            os.path.join(self.ctx.out_dir, "30-contigger",
                         "contigs.fasta"))
        plasmids = recover_short_plasmids(reads, contigs_store,
                                          self.ctx.platform)
        write_fasta(plasmids, self.out_files["plasmids"])
        # append to the contig set for polishing/finalization
        self._append(plasmids)

    def _append(self, plasmids):
        from flye_tpu_torch.contigger.extender import ContigInfo
        for name, codes in plasmids:
            self.ctx.contigs.append(ContigInfo(
                name=name, sequence=codes, length=len(codes),
                coverage=0, circular=True, repetitive=False,
                multiplicity=1, alt_group=-1, graph_path="*"))

    def load_state(self):
        store = SequenceStore.from_file(self.out_files["plasmids"])
        self._append([(store.name(i), store.get(i))
                      for i in store.ids()])


class JobPolishing(Job):
    name = "polishing"

    def __init__(self, ctx):
        super().__init__(ctx)
        d = ctx.subdir("40-polishing")
        self.out_files["polished"] = os.path.join(
            d, "filtered_contigs.fasta")
        self.out_files["stats"] = os.path.join(d, "polished_stats.txt")
        self.out_files["polished_gfa"] = os.path.join(
            d, "polished_edges.gfa")

    def run(self):
        from flye_tpu_torch.polishing.polisher import polish
        reads = self.ctx.load_reads()
        contigs_store = SequenceStore.from_file(
            os.path.join(self.ctx.out_dir, "30-contigger",
                         "contigs.fasta"))
        pairs = [(contigs_store.name(i), contigs_store.get(i))
                 for i in contigs_store.ids()]
        mb = (self.ctx.cfg.polish_max_bubble
              if "polish_max_bubble" in self.ctx.cfg else None)
        polished, coverage = polish(
            pairs, reads, self.ctx.platform,
            num_iters=self.ctx.args.iterations,
            return_coverage=True, max_bubble=mb, trim_ends=True)

        # final coverage filtering (reference: polish.py:210-261)
        covs = [coverage.get(n, 0) for n, _ in polished]
        med = np.median([c for c in covs if c > 0]) if any(covs) else 0
        min_cov = max(med / PIPELINE["relative_minimum_coverage"],
                      PIPELINE["hard_minimum_coverage"])
        kept = [(n, s) for (n, s), c in zip(polished, covs)
                if len(s) and c >= min_cov]
        if not kept:  # never drop the whole assembly
            kept = [(n, s) for n, s in polished if len(s)]
        write_fasta(kept, self.out_files["polished"])
        # splice polished sequence into the final graph's edges
        # (reference: flye/main.py:368 -> polish.py:142-207)
        from flye_tpu_torch.polishing.polished_edges import (
            generate_polished_gfa)
        cdir = os.path.join(self.ctx.out_dir, "30-contigger")
        n_upd = generate_polished_gfa(
            os.path.join(cdir, "graph_final.fasta"),
            os.path.join(cdir, "graph_final.gfa"),
            kept, self.out_files["polished_gfa"])
        logger.info("Polished %d graph edge sequences", n_upd)
        with open(self.out_files["stats"], "w") as f:
            f.write("#seq_name\tlength\tcoverage\n")
            for n, s in kept:
                f.write(f"{n}\t{len(s)}\t{int(coverage.get(n, 0))}\n")
        # update in-memory contigs with polished sequences
        by_name = dict(kept)
        for c in getattr(self.ctx, "contigs", []):
            if c.name in by_name:
                c.sequence = by_name[c.name]
                c.length = len(c.sequence)

    def load_state(self):
        """Reapply polished sequences to ctx.contigs from files."""
        store = SequenceStore.from_file(self.out_files["polished"])
        by_name = {store.name(i): store.get(i) for i in store.ids()}
        for c in getattr(self.ctx, "contigs", []):
            if c.name in by_name:
                c.sequence = by_name[c.name]
                c.length = len(c.sequence)


class JobFinalize(Job):
    name = "finalize"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.out_files["fasta"] = os.path.join(ctx.out_dir,
                                               "assembly.fasta")
        self.out_files["info"] = os.path.join(ctx.out_dir,
                                              "assembly_info.txt")

    def run(self):
        from flye_tpu_torch.pipeline.scaffolder import (build_scaffolds,
                                                        write_assembly)
        contigs = getattr(self.ctx, "contigs", [])
        links = getattr(self.ctx, "links", [])
        if not contigs:
            raise PipelineException("No contigs to finalize")
        scaffolds = build_scaffolds(contigs, links)
        write_assembly(contigs, scaffolds, self.out_files["fasta"],
                       self.out_files["info"])
        # final graph: polished-edge GFA when polishing ran
        # (reference: flye/main.py:269 copies polished_edges.gfa)
        polished_gfa = os.path.join(self.ctx.out_dir, "40-polishing",
                                    "polished_edges.gfa")
        raw_gfa = os.path.join(self.ctx.out_dir, "30-contigger",
                               "graph_final.gfa")
        gfa = polished_gfa if os.path.exists(polished_gfa) else raw_gfa
        if os.path.exists(gfa):
            shutil.copy(gfa, os.path.join(self.ctx.out_dir,
                                          "assembly_graph.gfa"))
        gv = os.path.join(self.ctx.out_dir, "30-contigger",
                          "graph_final.gv")
        if os.path.exists(gv):
            shutil.copy(gv, os.path.join(self.ctx.out_dir,
                                         "assembly_graph.gv"))


def create_job_list(ctx: RunContext) -> List[Job]:
    """The JAX package's job list (flye_tpu/main.py create_job_list)."""
    jobs: List[Job] = [JobConfigure(ctx), JobAssembly(ctx),
                       JobConsensus(ctx), JobRepeat(ctx)]
    # opt-in like the reference (flye/main.py:456); --no-trestle kept as
    # a legacy override
    if ctx.args.trestle and not ctx.args.no_trestle:
        jobs.append(JobTrestle(ctx))
    jobs.append(JobContigger(ctx))
    if ctx.args.plasmids and not ctx.args.meta:
        jobs.append(JobPlasmids(ctx))
    jobs.extend([JobPolishing(ctx), JobFinalize(ctx)])
    return jobs


def _setup_pipeline(args):
    """The run's context, its job list, the index of the first job to
    run (after the resume checks) and, in a multi-process run, its task
    bus."""
    from flye_tpu_torch.parallel.runtime import init_runtime

    ctx = RunContext(args)
    jobs = create_job_list(ctx)
    names = [j.name for j in jobs]
    if args.stop_after is not None and args.stop_after not in names:
        raise PipelineException(f"Unknown stage: {args.stop_after}")
    init_runtime(args.shards, args.device)

    start_from = 0
    if args.resume or args.resume_from:
        if not os.path.exists(ctx.params_file):
            raise PipelineException("Can't resume: no params.json found")
        with open(ctx.params_file) as f:
            state = json.load(f)
        if state.get("pipeline_version") != PIPELINE["pipeline_version"]:
            raise PipelineException(
                "Can't resume: pipeline version mismatch")
        ctx.min_overlap = state.get("min_overlap", 0)
        ctx.min_read_length = state.get("min_read_length", 0)
        target = args.resume_from or state.get("stage_name")
        if target not in names:
            raise PipelineException(f"Unknown stage: {target}")
        start_from = names.index(target)
        # stages before the resume point must be complete
        for j in jobs[:start_from]:
            if not j.completed():
                raise PipelineException(
                    f"Can't resume: stage '{j.name}' outputs missing")
        # configure must re-run to rebuild the in-memory config
        if start_from > 0:
            with trace.span(f"stage {jobs[0].name}"):
                jobs[0].run()

    from flye_tpu_torch.parallel.runtime import get_runtime
    rt = get_runtime()
    coordinator = rt.process_index == 0
    bus = None
    if rt.process_count > 1:
        # multi-process file bus: workers serve map and polish tasks
        # after contributing their ava shard; the coordinator fans them
        # out from its stages (the reference's analog is its process
        # pool over bubbles, flye/polishing/bubbles.py:96)
        from flye_tpu_torch.parallel.distributed import (
            set_barrier_abort_file, start_rendezvous)
        from flye_tpu_torch.parallel.taskbus import TaskBus, set_bus
        from flye_tpu_torch.polishing.polisher import \
            register_polish_handlers
        bus_dir = os.path.join(ctx.out_dir, ".taskbus")
        if coordinator:
            if os.path.isdir(bus_dir):
                shutil.rmtree(bus_dir)  # stale sentinels from a resume
            # stale barrier sentinels from a crashed prior attempt make
            # the barrier pass before workers republish their shards;
            # stale .partition transports would likewise be read as
            # fresh exchanges
            for stale in (glob.glob(os.path.join(ctx.out_dir, "*",
                                                 ".barriers")) +
                          glob.glob(os.path.join(ctx.out_dir, "*",
                                                 ".partition"))):
                shutil.rmtree(stale)
        # no process goes on before that cleanup is done
        start_rendezvous(ctx.out_dir)
        bus = TaskBus(bus_dir, rt.process_index)
        # workers abort barrier waits once the coordinator writes DONE
        # (e.g. a --stop-after stage the coordinator never enters)
        set_barrier_abort_file(os.path.join(bus_dir, "DONE"))
        register_polish_handlers(bus, prefer_native=not coordinator,
                                 reads_provider=ctx.load_reads)
        if coordinator:
            set_bus(bus)
    return ctx, jobs, start_from, bus


def run_pipeline(args) -> int:
    with trace.span("pipeline: setup"):
        ctx, jobs, start_from, bus = _setup_pipeline(args)
    from flye_tpu_torch.parallel.runtime import get_runtime
    rt = get_runtime()
    coordinator = rt.process_index == 0

    def _serve_worker():
        bus.serve()
        logger.info("worker process %d finished", rt.process_index)

    try:
        for i, job in enumerate(jobs):
            if i < start_from:
                job.load_state()
                continue
            if not coordinator and job.name not in ("configure",
                                                    "assembly"):
                # worker processes contribute the data-parallel ava
                # shard, then serve the bus until the coordinator
                # finishes
                _serve_worker()
                return 0
            if coordinator:  # workers must not race the checkpoint file
                job.save_checkpoint()
            logger.info(">>> STAGE: %s", job.name)
            with trace.span(f"stage {job.name}"):
                job.run()
            if args.stop_after == job.name:
                if not coordinator:
                    _serve_worker()
                    return 0
                logger.info("Stopped after stage '%s'", job.name)
                return 0
    finally:
        if bus is not None and coordinator:
            bus.shutdown()
            from flye_tpu_torch.parallel.taskbus import set_bus
            set_bus(None)
    if not coordinator:
        _serve_worker()
        return 0
    logger.info("Final assembly: %s",
                os.path.join(ctx.out_dir, "assembly.fasta"))
    return 0


def run_profiled(args) -> int:
    """run_pipeline under torch.profiler (the JAX package's
    jax.profiler.trace around its pipeline): host activity, and the
    device's when the run is on CUDA, no shapes or stacks; the trace
    goes to OUT_DIR/profile in TensorBoard's layout
    (<host>_<pid>.<ns>.pt.trace.json), with a range per stage ("stage
    <job>") and per step timer."""
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if args.device == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=activities, on_trace_ready=(
            tp.tensorboard_trace_handler(
                os.path.join(args.out_dir, "profile")))):
        return run_pipeline(args)


def parse_genome_size(text: Optional[str]) -> Optional[int]:
    if not text:
        return None
    text = text.strip().lower()
    mult = 1
    if text[-1] in "kmg":
        mult = {"k": 10 ** 3, "m": 10 ** 6, "g": 10 ** 9}[text[-1]]
        text = text[:-1]
    return int(float(text) * mult)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="flye_tpu_torch",
        description="GPU (PyTorch/CUDA) port of the flye_tpu de novo "
                    "assembler for long noisy reads")
    read_group = parser.add_mutually_exclusive_group(required=True)
    for flag in READ_TYPE_FLAGS:
        read_group.add_argument(f"--{flag.replace('_', '-')}", nargs="+",
                                metavar="reads", dest=flag)
    parser.add_argument("-o", "--out-dir", required=True)
    parser.add_argument("-g", "--genome-size", type=parse_genome_size,
                        default=None)
    parser.add_argument("-t", "--threads", type=int, default=1,
                        help="host threads")
    parser.add_argument("--shards", type=int, default=None,
                        help="devices in each process's mesh (default 1; "
                        "at most the visible devices of --device): with "
                        "more than one the indexes are hash-sharded "
                        "over them and the batched kernels split their "
                        "rows")
    parser.add_argument("--polish-target", default=None, metavar="FASTA",
                        help="run the standalone polisher on this "
                             "sequence file instead of assembling "
                             "(reference: flye --polish-target)")
    parser.add_argument("--hifi-error", type=float, default=None,
                        metavar="FLOAT",
                        help="expected HiFi error rate (e.g. 0.003); "
                             "only with --pacbio-hifi")
    parser.add_argument("-i", "--iterations", type=int, default=1,
                        help="number of polishing iterations")
    parser.add_argument("-m", "--min-overlap", type=int, default=None)
    parser.add_argument("--asm-coverage", type=int, default=None)
    parser.add_argument("--meta", action="store_true")
    parser.add_argument("--trestle", action="store_true",
                        help="enable Trestle unbridged-repeat "
                             "resolution (reference: flye --trestle, "
                             "opt-in since 2.8)")
    parser.add_argument("--no-trestle", action="store_true",
                        help=argparse.SUPPRESS)  # legacy opt-out
    parser.add_argument("--plasmids", action="store_true",
                        help="recover short unassembled plasmids "
                             "(skipped with --meta)")
    parser.add_argument("--keep-haplotypes", action="store_true")
    parser.add_argument("--nano-model", choices=["r94", "r7"],
                        default="r94",
                        help="nanopore pore chemistry error model "
                             "(only with --nano-raw/--nano-corr)")
    parser.add_argument("--extra-params", default=None)
    parser.add_argument("--config", default=None, metavar="CFG",
                        help="reference-format .cfg parameter file "
                             "(key = value, %%include supported) layered "
                             "over the built-in read-type defaults")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume-from", default=None)
    parser.add_argument("--stop-after", default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of the run "
                             "(host, and the device's kernels on CUDA) "
                             "under OUT_DIR/profile, for TensorBoard or "
                             "chrome://tracing (the analog of the "
                             "reference's gprof build)")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="device of the tensor work: cuda runs the "
                             "CUDA kernels (and fails without a GPU); cpu "
                             "runs their plain versions and the native "
                             "CPU climber")
    parser.add_argument("-v", "--version", action="version",
                        version="flye_tpu_torch 0.1.0")
    return parser


def _run_polisher_only(args) -> int:
    """Standalone polisher entry (reference: flye/main.py:509-518
    _run_polisher_only): polish an existing assembly with the given
    reads, writing polished_<i>.fasta per iteration."""
    from flye_tpu_torch.io.fasta import read_seq_file
    from flye_tpu_torch.parallel.runtime import init_runtime
    from flye_tpu_torch.polishing.polisher import polish

    with trace.span("pipeline: setup"):
        ctx = RunContext(args)
        init_runtime(args.shards, args.device)
        logger.info("Running standalone polisher on %s",
                    args.polish_target)
        target = read_seq_file(args.polish_target)
    if not target:
        raise PipelineException(f"empty target: {args.polish_target}")
    reads = ctx.load_reads()
    current = target
    for it in range(1, args.iterations + 1):
        current = polish(current, reads, ctx.platform, num_iters=1)
        out = os.path.join(args.out_dir, f"polished_{it}.fasta")
        write_fasta(current, out)
        logger.info("Polished iteration %d: %s", it, out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.hifi_error is not None:
        if not getattr(args, "pacbio_hifi", None):
            parser.error("--hifi-error can only be used with "
                         "--pacbio-hifi")
        # reference plumbing: flye/assembly/assemble.py:58-60 forwards
        # the rate as an assemble_ovlp_divergence override
        extra = f"assemble_ovlp_divergence={args.hifi_error}"
        args.extra_params = (f"{args.extra_params},{extra}"
                             if args.extra_params else extra)
    with trace.job(args.out_dir):
        return _run(args)


def _run(args) -> int:
    """One job: the polisher alone, or the pipeline (profiled with
    --profile); 1 with the error logged if it fails."""
    os.makedirs(args.out_dir, exist_ok=True)
    configure_logging(os.path.join(args.out_dir, "flye.log"),
                      debug=args.debug)
    if args.polish_target:
        try:
            return _run_polisher_only(args)
        except PipelineException as e:
            logger.error("%s", e)
            logger.error("Pipeline aborted")
            return 1
    try:
        if args.profile:
            return run_profiled(args)
        return run_pipeline(args)
    except PipelineException as e:
        logger.error("%s", e)
        logger.error("Pipeline aborted")
        return 1
    except Exception as e:  # device-failure diagnostics (the analog of
        # the reference's SIGKILL->"ran out of memory" translation,
        # reference: flye/assembly/assemble.py:70-73 + segfault
        # handlers in src/common/utils.h)
        msg = str(e)
        if "out of memory" in msg.lower():
            logger.error("Device out of memory: %s", msg.splitlines()[0])
        else:
            logger.exception("Unexpected failure")
        logger.error("Pipeline aborted")
        return 1


if __name__ == "__main__":
    sys.exit(main())
