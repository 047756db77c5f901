"""
The `profile` operation: BAM + FASTA -> profile directory.

Mirrors the reference's 5-step pipeline (controller.py:144-169):
validate -> filter reads -> profile scaffolds -> genome_wide -> plots,
with the process-pool split/merge machinery replaced by dense per-scaffold
kernel passes (see SURVEY §2.16 / §7).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from ..config import ProfileConfig
from ..io import fasta as fasta_io
from ..io.bam import decode_bam
from ..obs.logging import log_checkpoint
from ..store.profile_dir import ProfileDir
from ..store import generate as gen
from . import linkage as linkage_mod
from . import tables
from .filter_reads import filter_reads
from .pileup import ScaffoldStats, build_scaffold_pileup, \
    build_scaffold_pileup_padded, make_luts, run_site_stats


# Benchmark instrumentation (bench.py): wall-clock accounting of the
# main-thread phases of a profile run, so the batch breakdown sums to the
# steady wall time (round-3 verdict: ~23% was unattributed). None
# (production) adds no timers.
PHASES: Optional[Dict[str, float]] = None


class _phase:
    """Context manager accumulating wall seconds into PHASES[key]."""

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        if PHASES is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if PHASES is not None:
            PHASES[self.key] = (PHASES.get(self.key, 0.0) +
                                time.perf_counter() - self.t0)
        return False


@dataclass
class ScaffoldProfileResult:
    name: str
    length: int
    stats: ScaffoldStats
    snp_table: pd.DataFrame
    cumulative_snv_table: pd.DataFrame
    cumulative_scaffold_table: pd.DataFrame
    linkage_table: pd.DataFrame
    gene_results: Optional[tuple] = None


def profile(bam_path: str, fasta_path: str, cfg: ProfileConfig,
            output: Optional[str] = None) -> ProfileDir:
    """Run the full profile operation; returns the profile directory."""
    cfg.apply_database_mode()
    out_loc = output or cfg.output
    isdir = ProfileDir(out_loc)

    # per-run DEBUG file log (reference: controller.setup_logger writes
    # <out>/log/log.log; library runs get one too so the runtime report
    # and `other --run_statistics` work on any profile)
    _fh = logging.FileHandler(isdir.get_location("log") + "log.log")
    _fh.setLevel(logging.DEBUG)
    _fh.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-8s %(message)s",
        datefmt="%y-%m-%d %H:%M:%S"))
    _fh.addFilter(lambda r: not r.name.startswith(("jax", "matplotlib")))
    _root = logging.getLogger("")
    _old_level = _root.level
    if _old_level > logging.DEBUG:
        _root.setLevel(logging.DEBUG)
    _root.addHandler(_fh)
    try:
        return _profile_impl(bam_path, fasta_path, cfg, isdir)
    finally:
        _root.removeHandler(_fh)
        _root.setLevel(_old_level)
        _fh.close()


def _read_and_filter(bam_path: str, fasta_path: str, cfg: ProfileConfig):
    """Scaffold registry, decoded BAM and filtered read pairs; `owned` is
    this host's scaffold list under a sharded multi-host decode, else
    None."""
    registry = fasta_io.ScaffoldRegistry.from_fasta(
        fasta_path, window_length=cfg.window_length,
        use_full_header=cfg.use_full_fasta_header,
        scaffolds_to_profile=fasta_io.load_scaff_list(
            cfg.scaffolds_to_profile))

    ref_seqs = {n: fasta_io.CODE2BASE[np.minimum(registry.codes[n], 4)]
                for n in registry.names}
    # multi-host (DCN): shard the DECODE and FILTER stages too — each
    # host ranged-decodes only its owned scaffolds' BGZF blocks
    # (io/bai.py extents drive a decode-free greedy assignment) and the
    # only globally-coupled filter quantities (insert median, mapping
    # rows, Rdic) cross in two small allgathers
    # (filter_reads_distributed). Replaces the round-4 design where
    # decode + filtering replicated on every host.
    import jax
    owned = None
    if jax.process_count() > 1:
        owned = _plan_sharded_decode(bam_path, registry, cfg)
    if owned is not None:
        bam = decode_bam(bam_path, ref_seqs=ref_seqs,
                         threads=cfg.processes, baq=False,
                         scaffolds=owned)
        if bam.ranged:
            logging.info(
                f"sharded decode: host {jax.process_index()} "
                f"ranged-decoded {len(owned)} of {len(registry.names)} "
                f"scaffolds")
        else:
            logging.info("ranged decode unavailable; this host decoded "
                         "the full BAM (filtering stays sharded)")
        from .filter_reads import filter_reads_distributed
        pairs = filter_reads_distributed(
            bam, cfg.filter, registry.names, owned,
            skip_mm=cfg.skip_mm_profiling)
    else:
        bam = decode_bam(bam_path, ref_seqs=ref_seqs,
                         threads=cfg.processes, baq=False)
        if cfg.filter.maximum_reads:
            _subsample_bam(bam, cfg.filter.maximum_reads, cfg.seed)
        pairs = filter_reads(bam, cfg.filter, scaffolds=registry.names)
    return registry, bam, pairs, owned


def _select_scaffolds(registry, pairs, cfg: ProfileConfig) -> List[str]:
    """Scaffolds to profile, most read pairs first
    (reference: profile/fasta.py:87-136)."""
    s2p = pairs.scaffold2pairs
    keep = [n for n in registry.names
            if s2p.get(n, 0) >= cfg.min_scaffold_reads]
    if cfg.min_genome_coverage > 0:
        keep = _filter_genome_coverage(keep, registry, s2p,
                                       pairs.mean_pair_length, cfg)
    keep.sort(key=lambda n: s2p.get(n, 0), reverse=True)
    return keep


def choose_engine(engine: str, n_scaffolds: int, mesh=None) -> str:
    """The kernel path `--engine auto` resolves to: dense on a CPU backend
    without a mesh; otherwise batch for many scaffolds (one vmapped launch
    per shape bucket amortizes better) and hybrid for few."""
    if engine != "auto":
        return engine
    import jax
    if mesh is None and jax.default_backend() == "cpu":
        return "dense"
    return "batch" if n_scaffolds >= 16 else "hybrid"


def _make_mesh(cfg: ProfileConfig):
    if not (cfg.mesh_devices and cfg.mesh_devices > 1):
        return None
    # multi-device: shard the kernels over a 1-D device mesh (replaces the
    # reference's split/merge worker pools, profile_controller.py:157-271)
    from ..parallel.mesh import make_mesh
    logging.info(f"Sharding profile kernels over {cfg.mesh_devices} "
                 f"devices")
    return make_mesh(cfg.mesh_devices)


def profile_scaffolds(bam_path: str, fasta_path: str, cfg: ProfileConfig):
    """Everything `profile` computes before it writes the profile
    directory, held in memory: decode, read filtering, every scaffold's
    kernels, tables and linkage, on the engine `profile` would choose.
    Single-host. Returns (engine, per-scaffold payloads as
    `_finalize_result` makes them, in profiling order)."""
    cfg.apply_database_mode()
    registry, bam, pairs, _ = _read_and_filter(bam_path, fasta_path, cfg)
    if int(pairs.mapping_info["filtered_pairs"].iloc[0]) == 0:
        raise RuntimeError("No paired reads remain after filtering")
    keep = _select_scaffolds(registry, pairs, cfg)
    null_lut, freq_lut = make_luts(cfg.variant)
    gene_data = None
    if cfg.gene_file is not None:
        from . import genes as genes_mod
        gene_data = genes_mod.parse_genes(cfg.gene_file)
    mesh = _make_mesh(cfg)
    engine = choose_engine(cfg.engine, len(keep), mesh)
    if engine == "batch" and len(keep) > 1:
        finals = _profile_scaffolds_batched(
            bam, pairs, registry, keep, cfg, null_lut, freq_lut, gene_data,
            mesh=mesh)
    else:
        finals = _profile_each(bam, pairs, registry, keep, cfg, engine,
                               null_lut, freq_lut, gene_data, mesh)
    return engine, finals


def _profile_impl(bam_path: str, fasta_path: str, cfg: ProfileConfig,
                  isdir: ProfileDir) -> ProfileDir:
    import jax
    log_checkpoint("main_profile", "filter_reads", "start")
    registry, bam, pairs, owned = _read_and_filter(bam_path, fasta_path,
                                                   cfg)

    # store read-filtering results (reference: controller.py:260-322).
    # Under the batch engine this runs in a background thread overlapping
    # the device-launch loop (the gzip/json serialization is pure host
    # work, and blocked device calls release the GIL).
    def store_read_results():
        with _phase("store_reads"):
            isdir.store("object_type", "profile", "value",
                        "Type of SNVprofile (profile or compare)")
            isdir.store("bam_loc", bam_path, "value",
                        "Location of .bam file")
            isdir.store("mapping_info", pairs.mapping_info, "pandas",
                        "Report on reads")
            isdir.store("mapping_info_values",
                        {k: str(v) for k, v in pairs.filter_values.items()},
                        "dictionary", "Filter values used for mapping_info")
            isdir.store("fasta_loc", fasta_path, "value",
                        "Location of .fasta file used during profile")
            isdir.store("scaffold2length", registry.s2l, "dictionary",
                        "Dictionary of scaffold 2 length")
            if cfg.detailed_mapping_info:
                from .filter_reads import detailed_mapping_info
                isdir.store("detailed_mapping_info",
                            detailed_mapping_info(pairs.info, pairs.passed,
                                                  bam.ref_names,
                                                  bam.qnames),
                            "pandas", "Details report on reads")
            rdic = pairs.rdic(skip_mm=cfg.skip_mm_profiling)
            isdir.store("Rdic", rdic, "pickle" if cfg.skip_mm_profiling
                        else "dictionary",
                        "list of filtered read pairs"
                        if cfg.skip_mm_profiling
                        else "Read pair -> mismatches")

    total_pairs = int(pairs.mapping_info["filtered_pairs"].iloc[0])
    if total_pairs == 0:
        # persist the mapping report before aborting so a zero-pair run
        # can still be debugged from the profile dir (reference keeps it:
        # controller.py:260-322 stores before the 314-317 abort)
        store_read_results()
        raise RuntimeError(
            "No paired reads remain after filtering; consider "
            "--pairing_filter or --use_full_fasta_header")
    log_checkpoint("main_profile", "filter_reads", "end")

    # scaffold selection (reference: profile/fasta.py:87-136)
    log_checkpoint("main_profile", "profile_scaffolds", "start")
    s2p = pairs.scaffold2pairs
    keep = _select_scaffolds(registry, pairs, cfg)

    # multi-host (DCN): each process profiles only the scaffolds it owns,
    # then per-scaffold payloads allgather before table assembly
    # (reference analogue: the whole process-pool runtime, SURVEY §2.16 /
    # profile_controller.py:243-271). With sharded decode, ownership IS
    # the decode assignment (a host only holds its own scaffolds'
    # records); on the replicated fallback it is the canonical greedy
    # assignment by filtered-pair count. Either way the assignment and
    # every downstream table are deterministic across hosts.
    multi_host = jax.process_count() > 1
    if multi_host:
        if owned is not None:
            owned_set = set(owned)
            keep_local = [n for n in keep if n in owned_set]
        else:
            from ..parallel.distributed import my_scaffolds
            keep_local = my_scaffolds({n: s2p.get(n, 0) for n in keep})
            keep_local = [n for n in keep if n in set(keep_local)]
        logging.info(
            f"multi-host: process {jax.process_index()} of "
            f"{jax.process_count()} owns {len(keep_local)} of "
            f"{len(keep)} scaffolds")
    else:
        keep_local = keep

    null_lut, freq_lut = make_luts(cfg.variant)

    gene_data = None
    if cfg.gene_file is not None:
        from . import genes as genes_mod
        gene_data = genes_mod.parse_genes(cfg.gene_file)

    mesh = _make_mesh(cfg)
    engine = choose_engine(cfg.engine, len(keep_local), mesh)
    # multi-host output policy: under "primary" (default) only process 0
    # writes the profile outputs after the allgather — the reference's
    # single-output model; peers profile their shard, contribute to the
    # gather, and return. "all" makes every host materialize a complete
    # identical dir (byte-identity test mode).
    primary_peer = (multi_host and cfg.distributed_store != "all"
                    and jax.process_index() != 0)
    stream: Dict[str, object] = {}
    if engine == "batch" and len(keep_local) > 1:
        # write covT/clonT/clonTR hd5 datasets as each scaffold's result
        # lands, overlapping the device loop. Under multi-host the
        # payloads KEEP their special views (other hosts need them over
        # the allgather); the gathered scaffolds' datasets are written
        # through the same writers after the gather below.
        # The read-filtering stores overlap the same window in their own
        # thread; joined before the stream writers close (the writers
        # only touch the attribute registry at close, so the thread is
        # the registry's sole writer until then).
        import threading
        reads_err: List[BaseException] = []

        def _store_reads_bg():
            try:
                if not primary_peer:
                    store_read_results()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                reads_err.append(e)

        rt = threading.Thread(target=_store_reads_bg,
                              name="instrain-store-reads")
        rt.start()
        if not primary_peer:
            stream = {k: isdir.open_special_stream(k, d)
                      for k, d in _SPECIAL_DESCR.items()}
        try:
            finals = _profile_scaffolds_batched(
                bam, pairs, registry, keep_local, cfg, null_lut,
                freq_lut, gene_data, mesh=mesh, stream=stream,
                keep_special_payload=multi_host)
        except BaseException:
            rt.join()
            for w in stream.values():
                w.abort()
            raise
        rt.join()
        if reads_err:
            # the read-store failure aborts the run: close out the
            # still-open special writers instead of leaking unflushed
            # h5py handles (every other failure path aborts them too)
            for w in stream.values():
                w.abort()
            raise reads_err[0]
        if not multi_host:
            for w in stream.values():
                w.close()
    else:
        if not primary_peer:
            store_read_results()
        finals = _profile_each(bam, pairs, registry, keep_local, cfg,
                               engine, null_lut, freq_lut, gene_data, mesh)
    if multi_host:
        from ..parallel.distributed import allgather_tables

        # the special views cross hosts as compact numpy pairs
        # (int32 positions + original-dtype values) instead of pickled
        # pandas Series:
        # ~2x fewer bytes into the zlib gather payload, and Series
        # construction happens only for scaffolds this host must write
        def _pack_view(view):
            return {mm: (s.index.values.astype(np.int32), s.values)
                    for mm, s in view.items()}

        def _unpack_view(packed):
            return {mm: pd.Series(v, index=i.astype(np.int64))
                    for mm, (i, v) in packed.items()}

        # one try around the WHOLE multi-host tail (allgather → sort →
        # remainder writes): a failure anywhere must abort the still-open
        # SpecialStreamWriters, not leak unflushed h5py handles
        try:
            log_checkpoint("main_profile", "allgather_results", "start")
            local_names = {r["name"] for r in finals}
            for fin in finals:
                for attr in _SPECIAL_DESCR:
                    fin[attr] = _pack_view(fin[attr])
            finals = allgather_tables(finals)
            # canonical single-process order (keep is sorted identically
            # on every host), so multi-host output is byte-identical to
            # 1-proc
            order = {n: i for i, n in enumerate(keep)}
            finals.sort(key=lambda r: order.get(r["name"], len(order)))
            log_checkpoint("main_profile", "allgather_results", "end")
            if primary_peer:
                # this host's contribution is in the gather; process 0
                # writes the single output (reference: one profile dir)
                log_checkpoint("main_profile", "profile_scaffolds",
                               "end")
                return isdir
            if stream:
                # own scaffolds were hd5-streamed inside the device-loop
                # overlap window; write the gathered remainder now and
                # drop every special view from the payloads (prewritten)
                for fin in finals:
                    mine = fin["name"] in local_names
                    for attr, w in stream.items():
                        view = fin.pop(attr)
                        if not mine:
                            w.write(fin["name"], _unpack_view(view))
                for w in stream.values():
                    w.close()
            else:
                for fin in finals:
                    for attr in _SPECIAL_DESCR:
                        fin[attr] = _unpack_view(fin[attr])
        except BaseException:
            for w in stream.values():
                w.abort()
            raise
    with _phase("store_results"):
        _store_results(isdir, finals, bam_path, cfg, gene_data,
                       prewritten=frozenset(stream))
    log_checkpoint("main_profile", "profile_scaffolds", "end")

    # outputs (reference: controller.py:352-360)
    with _phase("generate"):
        for t in ["SNVs", "scaffold_info", "linkage", "gene_info"]:
            gen.generate(isdir, t, mm_level=cfg.mm_level,
                         force_compress=cfg.force_compress)
        gen.generate(isdir, "mapping_info",
                     force_compress=cfg.force_compress)

    if not cfg.skip_genome_wide:
        log_checkpoint("main_profile", "genome_wide", "start")
        from ..profile import genome as genome_mod
        genome_mod.genome_wide(isdir, stb=cfg.stb, mm_level=cfg.mm_level,
                               skip_mm_profiling=cfg.skip_mm_profiling)
        log_checkpoint("main_profile", "genome_wide", "end")

    if not cfg.skip_plot_generation:
        try:
            from ..plotting.controller import make_plots
            make_plots(isdir, plots="a")
        except Exception as e:  # plots must never fail a profile run
            logging.error(f"Plotting failed: {e}")

    if cfg.debug:
        # runtime/failure report (reference: controller.py:121-129 +
        # logUtils.report_run_stats)
        from ..obs.logging import report_run_stats
        logloc = isdir.get_location("log") + "log.log"
        try:
            report_run_stats(logloc, printToo=False,
                             output=isdir.get_location("log") +
                             "runtime_summary.txt")
        except Exception:
            logging.debug("run report failed", exc_info=True)

    return isdir


def _profile_each(bam, pairs, registry, keep, cfg, engine, null_lut,
                  freq_lut, gene_data, mesh) -> List[Dict]:
    """Per-scaffold path: one kernel launch per scaffold on `engine`
    (batch degrades to hybrid here). Returns finalized payloads."""
    from ..obs.logging import get_worker_log, progress
    if engine == "batch":
        engine = "hybrid"
    results: List[ScaffoldProfileResult] = []
    cfg_engine, cfg.engine = cfg.engine, engine
    try:
        for name in progress(keep, desc="Profiling splits"):
            logging.debug(get_worker_log("SplitProfile", name, "start"))
            res = _profile_one_scaffold(bam, pairs, registry, name, cfg,
                                        null_lut, freq_lut, gene_data,
                                        mesh=mesh)
            logging.debug(get_worker_log("SplitProfile", name, "end"))
            if res is not None:
                results.append(res)
    finally:
        cfg.engine = cfg_engine
    return [_finalize_result(r, cfg) for r in results]


def _profile_one_scaffold(bam, pairs, registry, name, cfg, null_lut,
                          freq_lut, gene_data, mesh=None):
    try:
        return _profile_one_scaffold_inner(bam, pairs, registry, name, cfg,
                                           null_lut, freq_lut, gene_data,
                                           mesh=mesh)
    except Exception as e:
        # per-scaffold failure containment (reference:
        # profile_utilities.py:92-112 SplitException / MergeError)
        from ..obs.logging import log_failure
        log_failure("SplitException", name, str(e))
        logging.error(f"whole scaffold exception- {name}")
        return None


def _profile_one_scaffold_inner(bam, pairs, registry, name, cfg, null_lut,
                                freq_lut, gene_data, mesh=None):
    # fault-injection hook (reference: FailureScaffoldHeaderTesting magic
    # name, profile_utilities.py:137-139)
    if name == "FailureScaffoldHeaderTesting" and getattr(cfg, "debug",
                                                          False):
        raise AssertionError("injected failure for testing")
    rid = bam.name_to_ref_id.get(name)
    if rid is None:
        return None
    L = registry.length_of(name)
    engine = cfg.engine
    if mesh is not None:
        # sharded execution goes through the two-phase hybrid path
        # (position axis split over the mesh, parallel/mesh.py)
        engine = "hybrid"
    elif engine == "auto":
        import jax
        engine = "dense" if jax.default_backend() == "cpu" else "hybrid"
    # the hybrid (device-compaction) engine transfers the count tensor to
    # the device: build it natively pre-padded in int16 (half the bytes,
    # no host padding pass); skip_mm collapses levels on host, which
    # needs the plain int32 tensor
    if engine == "hybrid" and not cfg.skip_mm_profiling:
        pileup = build_scaffold_pileup_padded(bam, pairs, rid, L)
    else:
        pileup = build_scaffold_pileup(bam, pairs, rid, L)
    if pileup is None:
        return None
    if cfg.skip_mm_profiling:
        # collapse the mm axis: every pair counts at level 0 (explicit
        # int32: numpy's sum would upcast to int64 and double h2d bytes)
        pileup.counts = pileup.counts.sum(axis=0, keepdims=True,
                                          dtype=np.int32)
        pileup.mm_values = np.array([0])
        pileup.qid2mmidx = np.where(pileup.qid2mmidx >= 0, 0,
                                    -1).astype(np.int32)

    ref_codes = registry.codes[name]
    M, _, Lc = pileup.counts.shape
    if (engine == "hybrid" and
            M * Lc > (1 << 27) * (mesh.devices.size if mesh is not None
                                  else 1)):
        # the one-launch compact path needs the whole [M, 4, L] working
        # set on device (split across the mesh when sharded); very long
        # scaffolds go through the position-chunked dense path instead
        engine = "dense"
        mesh = None
    if engine == "hybrid":
        # device-side compaction + storage-needed dense arrays only
        from . import compact as compact_mod
        stats = compact_mod.run_site_stats_hybrid(
            pileup, ref_codes, null_lut, freq_lut,
            min_cov=cfg.variant.min_cov,
            rarefied_coverage=cfg.rarefied_coverage, seed=cfg.seed,
            mesh=mesh)
    else:
        stats = run_site_stats(pileup, ref_codes, null_lut, freq_lut,
                               min_cov=cfg.variant.min_cov,
                               rarefied_coverage=cfg.rarefied_coverage,
                               seed=cfg.seed)
    return _result_from_stats(name, L, stats, ref_codes, cfg, gene_data)


def _result_from_stats(name, L, stats, ref_codes, cfg, gene_data):
    """Tables + linkage + genes from per-scaffold stats (compact or
    dense)."""
    from . import compact as compact_mod
    if isinstance(stats, compact_mod.CompactStats):
        snp, csnv = compact_mod.snp_tables_compact(stats, ref_codes)
        ctable = compact_mod.coverage_table_compact(stats)
    else:
        snp = tables.snp_table(stats, ref_codes)
        csnv = tables.cumulative_snv_table(snp)
        ctable = tables.coverage_table(stats, snp)
    ws = linkage_mod.window_starts_for(L, cfg.window_length)
    ld = linkage_mod.calculate_linkage(stats, ws, min_snp=int(cfg.min_snp),
                                      seed=cfg.seed)

    gene_results = None
    if gene_data is not None and name in gene_data.scaff2genes:
        from . import genes as genes_mod
        try:
            gene_results = genes_mod.profile_genes_for_scaffold(
                name, gene_data, stats, csnv)
        except Exception as e:
            # gene failures don't kill the scaffold profile (reference:
            # profile_utilities.py:388-396 GeneException)
            from ..obs.logging import log_failure
            log_failure("GeneException", name, str(e))

    return ScaffoldProfileResult(
        name=name, length=L, stats=stats, snp_table=snp,
        cumulative_snv_table=csnv, cumulative_scaffold_table=ctable,
        linkage_table=ld, gene_results=gene_results)


_SPECIAL_DESCR = {
    "covT": "Scaffold -> mm -> position based coverage",
    "clonT": "Scaffold -> mm -> position based clonality",
    "clonTR": "Scaffold -> mm -> rarefied position based clonality",
}


def _profile_scaffolds_batched(bam, pairs, registry, keep, cfg, null_lut,
                               freq_lut, gene_data, mesh=None,
                               stream=None, keep_special_payload=False):
    """Many-scaffold path: one vmapped kernel launch per (M, L) shape
    bucket instead of one per scaffold (metagenome assemblies commonly
    have thousands of small contigs; per-launch dispatch would dominate).
    Scaffolds that overflow the fixed batch capacities transparently
    re-run on the right-sizing per-scaffold path. With `mesh`, each
    bucket stack is sharded over the device mesh on the scaffold axis.

    Returns FINALIZED per-scaffold payload dicts (_finalize_result).
    With `stream` ({attr -> SpecialStreamWriter}), each scaffold's
    covT/clonT/clonTR views are written to their hd5 files here — inside
    the device-loop overlap window — and dropped from the payload."""
    import queue as queue_mod

    from ..obs.logging import get_worker_log, log_failure, progress
    from . import compact as compact_mod

    # STREAMING producer: pileups are built here on the main thread and
    # enqueued to the device thread as they finish — the first kernel
    # launch dispatches while later pileups are still being built (the
    # reference's split workers likewise stream into merge workers,
    # profile_controller.py:157-193). Blocked device calls release the
    # GIL, so builds overlap launches.
    from .pileup import _bucket

    in_q: "queue_mod.Queue" = queue_mod.Queue()
    pileups, codes, metas = [], [], []
    dense_idx: set = set()   # oversized scaffolds: position-chunked path
    mesh_n = mesh.devices.size if mesh is not None else 1

    def produce_pileups():
        try:
            for name in progress(keep, desc="Building pileups"):
                logging.debug(get_worker_log("SplitProfile", name,
                                             "start"))
                rid = bam.name_to_ref_id.get(name)
                if rid is None:
                    continue
                L = registry.length_of(name)
                # very long scaffolds exceed the one-launch device
                # working set: divert to the position-chunked dense
                # path instead of force-feeding the batch/hybrid
                # kernels (same guard as _profile_one_scaffold_inner)
                oversize = False
                if not cfg.skip_mm_profiling:
                    qids_, mms_ = pairs.r2m_for_scaffold(rid)
                    n_mm = len(np.unique(mms_)) if len(qids_) else 0
                    Mp_est = max(_bucket(max(n_mm, 1), 8), 8)
                    Lp_est = max(_bucket(L, 4096), 4096)
                    oversize = Mp_est * Lp_est > (1 << 27) * mesh_n
                try:
                    if cfg.skip_mm_profiling or oversize:
                        pu = build_scaffold_pileup(bam, pairs, rid, L)
                    else:
                        pu = build_scaffold_pileup_padded(bam, pairs,
                                                          rid, L)
                except Exception as e:
                    log_failure("SplitException", name, str(e))
                    continue
                if pu is None:
                    continue
                if cfg.skip_mm_profiling:
                    pu.counts = pu.counts.sum(axis=0, keepdims=True,
                                              dtype=np.int32)
                    pu.mm_values = np.array([0])
                    pu.qid2mmidx = np.where(pu.qid2mmidx >= 0, 0,
                                            -1).astype(np.int32)
                i = len(pileups)
                pileups.append(pu)
                codes.append(registry.codes[name])
                metas.append((name, L))
                if oversize:
                    dense_idx.add(i)   # handled in the retry phase
                else:
                    in_q.put((i, pu, registry.codes[name]))
        finally:
            in_q.put(None)  # end-of-input sentinel, even on failure

    # Per-scaffold table building — and, with `stream`, the
    # covT/clonT/clonTR hd5 writes — overlaps the device loop as each
    # launch's stats land, instead of following serially. The hd5
    # writes run on their OWN thread: h5py/lzf release the GIL, so
    # they genuinely parallel the consumer's pandas work on a second
    # core instead of serializing behind it.
    import threading
    hd5_q: "queue_mod.Queue" = queue_mod.Queue()
    hd5_err: List[BaseException] = []

    def hd5_worker():
        from ..obs.logging import log_failure
        while True:
            item = hd5_q.get()
            if item is None:
                return
            name, views = item
            try:
                with _phase("hd5_stream"):
                    for attr, writer in stream.items():
                        writer.write(name, views[attr])
            except Exception as e:
                # PER-SCAFFOLD containment, same as when these writes
                # ran inline in handle(): one bad write costs that
                # scaffold's special datasets, never the run
                log_failure("SpecialWriteError", name, str(e))
                logging.error(f"hd5 stream write failed for {name}: {e}")
            except BaseException as e:  # noqa: BLE001 — re-raised below
                hd5_err.append(e)
                return

    hd5_t = None
    if stream:
        hd5_t = threading.Thread(target=hd5_worker, daemon=True,
                                 name="instrain-hd5-stream")
        hd5_t.start()

    def handle(i, stats):
        name, L = metas[i]
        with _phase("tables"):
            result = _result_from_stats(name, L, stats, codes[i], cfg,
                                        gene_data)
            fin = _finalize_result(result, cfg)
        if stream:
            # multi-host keeps the view in the payload: peer hosts
            # receive it over the allgather and write it themselves
            views = {attr: (fin[attr] if keep_special_payload
                            else fin.pop(attr))
                     for attr in stream}
            hd5_q.put((name, views))
        finals_map[i] = fin

    finals_map: Dict[int, Dict] = {}
    retry_idx: List[int] = []
    seen = set()
    # the device thread starts consuming in_q EAGERLY here (before any
    # result is pulled): launches begin as soon as the first shape-bucket
    # chunk fills, overlapping the remaining pileup builds
    it = iter(compact_mod.iter_site_stats_compact_batch(
        None, None, null_lut, freq_lut, in_queue=in_q,
        min_cov=cfg.variant.min_cov,
        rarefied_coverage=cfg.rarefied_coverage, seed=cfg.seed,
        with_dense=True, mesh=mesh))
    def _join_hd5():
        if hd5_t is not None:
            hd5_q.put(None)
            hd5_t.join()
            if hd5_err:
                raise hd5_err[0]

    try:
        produce_pileups()
    except BaseException:
        # catastrophic producer failure: the sentinel is already queued
        # (produce_pileups' finally); drain the device thread before
        # propagating so no launch is in flight when the caller aborts
        # (and the hd5 thread before the caller aborts its writers)
        for _ in it:
            pass
        try:
            _join_hd5()
        except BaseException:
            pass
        raise
    if not pileups:
        for _ in it:  # joins the device thread, stops the watchdog
            pass
        _join_hd5()
        return []
    bar = progress(desc="Profiling scaffolds", total=len(pileups))
    try:
        while True:
            # time blocked on the device thread separately from the
            # consumer's own table building (bench breakdown accounting)
            with _phase("batch_wait"):
                try:
                    i, stats = next(it)
                except StopIteration:
                    break
            seen.add(i)
            name = metas[i][0]
            if stats is None:  # batch capacity overflow -> right-size
                retry_idx.append(i)
                continue
            try:
                handle(i, stats)
            except Exception as e:
                log_failure("SplitException", name, str(e))
                logging.error(f"whole scaffold exception- {name}")
            logging.debug(get_worker_log("SplitProfile", name, "end"))
            bar.update()
    except Exception as e:
        # engine containment: a kernel-engine exception must not kill the
        # run (the reference contains per-unit failures and continues,
        # profile_utilities.py:92-112). The engine error is re-raised
        # only after the device thread has drained, so no launch is in
        # flight here. Every not-yet-landed scaffold retries on the
        # right-sizing per-scaffold hybrid path below.
        log_failure("EngineException", "batch_engine", str(e))
        logging.error(f"batch engine failed ({e}); retrying every "
                      f"scaffold on the per-scaffold path")
        retry_idx.extend(i for i in range(len(pileups))
                         if i not in seen and i not in dense_idx)

    # per-scaffold retries (and the diverted oversized scaffolds) run
    # AFTER the device thread has finished, so two threads never launch
    # at once
    retry_idx.extend(sorted(dense_idx))
    with _phase("retry"):
        for i in retry_idx:
            name = metas[i][0]
            try:
                if i in dense_idx:
                    # position-chunked dense path: the whole [M, 4, L]
                    # working set never has to fit on device at once
                    stats = run_site_stats(
                        pileups[i], codes[i], null_lut, freq_lut,
                        min_cov=cfg.variant.min_cov,
                        rarefied_coverage=cfg.rarefied_coverage,
                        seed=cfg.seed)
                else:
                    stats = compact_mod.run_site_stats_hybrid(
                        pileups[i], codes[i], null_lut, freq_lut,
                        min_cov=cfg.variant.min_cov,
                        rarefied_coverage=cfg.rarefied_coverage,
                        seed=cfg.seed, mesh=mesh)
                handle(i, stats)
            except Exception as e:
                log_failure("SplitException", name, str(e))
                logging.error(f"whole scaffold exception- {name}")
            logging.debug(get_worker_log("SplitProfile", name, "end"))
            bar.update()
    bar.close()
    # all handle() calls (incl. retries) have enqueued their views; the
    # caller closes the stream writers only after this join
    _join_hd5()
    return [finals_map[i] for i in sorted(finals_map)]


def _finalize_result(r: ScaffoldProfileResult, cfg) -> Dict:
    """Convert a ScaffoldProfileResult into a plain serializable payload
    (tables + host-materialized covT/clonT views + linkage capture). This
    is the unit that crosses hosts under multi-process execution — the
    stats object itself holds zero-copy views into native decoder memory
    and never leaves its process (reference analogue: the pickled
    SplitObjects crossing the worker queues, profile_utilities.py:823-858).
    """
    out = dict(
        name=r.name, length=r.length,
        snp_table=r.snp_table,
        cumulative_snv_table=r.cumulative_snv_table,
        cumulative_scaffold_table=r.cumulative_scaffold_table,
        linkage_table=r.linkage_table,
        gene_results=r.gene_results,
        covT=tables.covT_view(r.stats),
        clonT=tables.clonT_view(r.stats),
        clonTR=tables.clonT_view(r.stats, rarefied=True),
        reads_to_snvs=_reads_to_snvs(r.stats),
    )
    if cfg.store_everything:
        out["counts_sum"] = r.stats.pileup.counts_exact.sum(axis=0).T
    return out


def _store_results(isdir: ProfileDir, finals: List[Dict], bam_path, cfg,
                   gene_data, prewritten=frozenset()):
    """reference: profile_utilities.gen_snv_profile (614-717).
    `prewritten` names special attrs already written incrementally by the
    batch consumer's stream writers (and absent from the payloads)."""
    def cat(dfs):
        dfs = [d for d in dfs if d is not None and len(d)]
        return (pd.concat(dfs).reset_index(drop=True) if dfs
                else pd.DataFrame())

    isdir.store("scaffold_list", [r["name"] for r in finals], "list",
                "1d list of scaffolds that were profiled")
    mi = isdir.get("mapping_info")
    s2fp = mi.set_index("scaffold")["filtered_pairs"].to_dict()
    isdir.store("window_table", pd.DataFrame(
        {"scaffold": [r["name"] for r in finals],
         "end": [r["length"] for r in finals],
         "start": [0] * len(finals),
         "filtered_pairs": [s2fp.get(r["name"], 0) for r in finals]}),
        "pandas", "Windows profiled over")
    isdir.store("raw_linkage_table",
                cat([r["linkage_table"] for r in finals]),
                "pandas", "Raw table of linkage information")
    raw_snp = cat([r["snp_table"] for r in finals])
    isdir.store("raw_snp_table",
                raw_snp.drop(columns=[c for c in ("var_freq", "con_freq",
                                                  "ref_freq")
                                      if c in raw_snp.columns]),
                "pandas", "Contains raw SNP information on a mm level")
    isdir.store("cumulative_scaffold_table",
                cat([r["cumulative_scaffold_table"] for r in finals]),
                "pandas", "Cumulative coverage on mm level")
    isdir.store("cumulative_snv_table",
                cat([r["cumulative_snv_table"] for r in finals]),
                "pandas", "Cumulative SNP on mm level")

    for attr, descr in _SPECIAL_DESCR.items():
        if attr not in prewritten:
            isdir.store(attr, {r["name"]: r[attr] for r in finals},
                        "special", descr)

    if cfg.store_everything:
        # per-scaffold summed ACTG pileup counts (reference: counts_table,
        # gen_snv_profile 709-715 — [L, 4] per scaffold)
        isdir.store("counts_table", [r["counts_sum"] for r in finals],
                    "pickle",
                    "1d numpy array of 2D counts tables for each scaffold")
        # reference also persists the linkage capture inputs per scaffold
        # when store_everything (gen_snv_profile 697-707)
        isdir.store("read_to_snvs",
                    {r["name"]: r["reads_to_snvs"] for r in finals},
                    "pickle", "Scaffold -> mm -> read -> SNVs")

    # linkage capture structure (reference stores it for pooling/debug)
    isdir.store("scaffold_2_mm_2_read_2_snvs",
                {r["name"]: r["reads_to_snvs"] for r in finals}, "pickle",
                "scaffold -> mm -> read -> SNVs (linkage capture)")

    if gene_data is not None:
        isdir.store("genes_fileloc", cfg.gene_file, "value",
                    "Location of genes file that was used to call genes")
        isdir.store("genes_table", gene_data.gene_table, "pandas",
                    "Location of genes in the associated genes_file")
        per_name = {0: "genes_coverage", 1: "genes_clonality",
                    2: "genes_SNP_count", 3: "SNP_mutation_types"}
        descr = {0: "Coverage of individual genes",
                 1: "Clonality of individual genes",
                 2: "SNP density and counts of individual genes",
                 3: "The mutation types of SNPs"}
        for i, attr in per_name.items():
            isdir.store(attr, cat([r["gene_results"][i] for r in finals
                                   if r["gene_results"] is not None]),
                        "pandas", descr[i])


def _reads_to_snvs(stats: ScaffoldStats) -> Dict[int, Dict[str, list]]:
    """mm -> qname_id -> ['pos:base'] for captured linkage reads."""
    from collections import defaultdict
    from .linkage import counted_snv_events
    pu = stats.pileup
    # shared with linkage capture (one native event scan per scaffold)
    pos, base, mm_idx, qn = counted_snv_events(stats)
    if len(pos) == 0:
        return {}
    mm = pu.mm_values[mm_idx]
    out: Dict[int, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    bchar = "ACTG"
    for p, b, m, q in zip(pos.tolist(), base.tolist(), mm.tolist(),
                          qn.tolist()):
        out[m][q].append(f"{p}:{bchar[b]}")
    return {m: dict(v) for m, v in out.items()}


def _plan_sharded_decode(bam_path, registry, cfg):
    """Decode-free multi-host scaffold assignment: greedy bin-packing of
    the .bai per-reference COMPRESSED byte extents (a ~read-count proxy
    available before any decode; the reference's analogous balancing is
    pair-count based and runs post-decode,
    profile_controller.py:460-465). Returns this host's owned scaffold
    list, or None when a globally-coupled option forces the replicated
    full-decode path:
      - pairing_filter != paired_only (non_discordant / all_reads
        inspect one qname's mappings ACROSS scaffolds,
        filter_reads.py:471-542)
      - detailed_mapping_info (a global per-pair table)
      - maximum_reads subsampling (the kept-template hash set must span
        the whole BAM)
      - no .bai index
    The plan is a pure function of the BAM + config, and a digest
    allgather (always executed in the multi-host path, so collective
    order stays aligned) verifies every host computed the same one —
    a host-local failure (transient I/O, differing file view) downgrades
    ALL hosts to the replicated path together instead of
    desynchronizing the later collectives.
    """
    import hashlib

    import jax

    weights = None
    if (cfg.filter.pairing_filter == "paired_only" and
            not cfg.detailed_mapping_info and
            not cfg.filter.maximum_reads):
        from ..io.bai import (find_bai, read_bam_ref_names,
                              read_ref_extents)
        bai = find_bai(bam_path)
        if bai is not None:
            try:
                extents = read_ref_extents(bai)
                names = read_bam_ref_names(bam_path)
                name_set = set(registry.names)
                weights = {n: (int(extents[i]) if i < len(extents)
                               else 0)
                           for i, n in enumerate(names) if n in name_set}
                if not weights:
                    weights = None
            except Exception as e:
                logging.info(f"sharded decode unavailable ({e}); "
                             f"replicating")
                weights = None

    # COLLECTIVE agreement: the plan must be identical on every host or
    # the later collectives desynchronize (one host on the replicated
    # path while peers run the distributed filter's allgathers). One
    # tiny fixed-position allgather compares a digest of each host's
    # plan; any mismatch or failure makes EVERY host replicate.
    from ..parallel.distributed import (allgather_tables,
                                        assign_scaffolds_to_hosts)
    if weights is None:
        digest = ""
    else:
        h = hashlib.sha256()
        for n in sorted(weights):
            h.update(f"{n}\0{weights[n]}\n".encode())
        digest = h.hexdigest()
    digests = allgather_tables([digest])
    if not digest or any(d != digest for d in digests):
        if digest:
            logging.info("sharded-decode plans differ across hosts; "
                         "replicating decode+filter everywhere")
        return None
    bins = assign_scaffolds_to_hosts(weights, jax.process_count())
    return bins[jax.process_index()]


def _subsample_bam(bam, maximum_reads: int, seed: int):
    """
    Deterministic template-level subsampling to ~maximum_reads records
    (the reference shells out to samtools view -s, which keeps/drops whole
    read templates by name hash; samtools_ops.py:159-164). Record-table
    entries of dropped qnames are removed; the native event buffers are
    left in place and stay consistent because pair selection drives every
    downstream native call.
    """
    n = bam.n_records
    if n <= maximum_reads:
        return
    frac = maximum_reads / n
    n_q = bam.n_qnames or int(bam.qname_id.max()) + 1
    rng = np.random.default_rng(seed)
    keep_q = rng.random(n_q) < frac
    keep = keep_q[bam.qname_id]
    for f in ("ref_id", "pos", "flag", "mapq", "nm", "qname_id",
              "qlen_infer", "ref_start", "ref_end", "tlen", "mate_pos",
              "mate_ref", "ev_off", "ev_len", "pileup_ok"):
        setattr(bam, f, getattr(bam, f)[keep])
    logging.info(f"Subsampled to {bam.n_records} of {n} records "
                 f"(--maximum_reads {maximum_reads})")


def _filter_genome_coverage(keep, registry, s2p, read_length, cfg):
    """reference: profile/fasta.py:109-136."""
    from ..io.stb import load_scaff2bin
    stb = load_scaff2bin(cfg.stb)
    genome_pairs: Dict[str, int] = {}
    genome_len: Dict[str, int] = {}
    for name in keep:
        g = stb.get(name)
        if g is None:
            continue
        genome_pairs[g] = genome_pairs.get(g, 0) + s2p.get(name, 0)
        genome_len[g] = genome_len.get(g, 0) + registry.length_of(name)
    bad_genomes = {g for g in genome_pairs
                   if genome_pairs[g] * read_length / genome_len[g] <
                   cfg.min_genome_coverage}
    return [n for n in keep
            if stb.get(n) is not None and stb[n] not in bad_genomes]
