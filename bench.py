#!/usr/bin/env python
"""
Benchmark (driver-run): ONE JSON line with two end-to-end numbers.

1. headline `value`: filtered read pairs per second through the full
   profile flow on the sars-cov-2 test BAM (single scaffold: decode ->
   filter -> pileup -> compact site-stats kernel -> SNV/linkage/scaffold
   tables), steady-state.
2. `detail.batch`: the metagenome-scale production path — full profile()
   through the vmapped batch engine over a synthetic >=5 Mbp
   multi-scaffold assembly (128 scaffolds x 40 kb, ~30x coverage,
   planted strain variants; see bench_batch.synth).

Both report a per-phase breakdown (decode / filter / pileup-build /
pack / h2d / compute / fetch / tables+linkage) so single-chip efficiency
is judgeable: the device numbers come from synchronized timers inside
profile/compact.py (compact.TIMINGS).

Baseline: the reference's internal scheduler cost model of
0.0061401594694834305 s/pair + overhead (~163 pairs/s/core;
inStrain/profile/profile_controller.py:460-465) at its documented 6-core
operating point => 977 pairs/s.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BAM = ("/root/reference/test/test_data/"
       "sars_cov_2_MT039887.1.fasta.bt2-vs-SRR11140750.sorted.bam")
GB = "/root/reference/test/test_data/sars_cov_2_MT039887.1.gb"

BASELINE_PAIRS_PER_SEC = 6 / 0.0061401594694834305  # 6-core reference


def load_ref():
    txt = open(GB).read()
    seq = "".join(re.findall("[a-zA-Z]+",
                             txt.split("ORIGIN")[1].split("//")[0])).upper()
    return np.frombuffer(seq.encode(), dtype=np.uint8)


def run_once_sars(refseq, luts, phases=None):
    from instrain_tpu.config import ReadFilterConfig
    from instrain_tpu.io.bam import decode_bam
    from instrain_tpu.io.fasta import seq_to_codes
    from instrain_tpu.profile import compact
    from instrain_tpu.profile import linkage as linkage_mod
    from instrain_tpu.profile import tables
    from instrain_tpu.profile.filter_reads import filter_reads
    from instrain_tpu.profile.pileup import build_scaffold_pileup_padded

    def mark(key, t0):
        t1 = time.perf_counter()
        if phases is not None:
            phases[key] = phases.get(key, 0.0) + (t1 - t0)
        return t1

    t = time.perf_counter()
    bam = decode_bam(BAM, ref_seqs={"MT039887.1": refseq}, baq=False)
    t = mark("decode", t)
    pairs = filter_reads(bam, ReadFilterConfig())
    t = mark("filter", t)
    pu = build_scaffold_pileup_padded(bam, pairs, 0, len(refseq))
    t = mark("pileup_build", t)
    rc = seq_to_codes(refseq)
    # compact path: stats + table inputs computed on device, KB-scale
    # device->host transfers (pack/h2d/compute/fetch recorded by
    # compact.TIMINGS when the benchmark enables it)
    cs = compact.run_site_stats_compact(pu, rc, *luts)
    t = mark("device_total", t)
    snp = compact.snp_table_compact(cs, rc)
    csnv = tables.cumulative_snv_table(snp)
    ctab = compact.coverage_table_compact(cs)
    ws = linkage_mod.window_starts_for(len(refseq), 10000)
    ld = linkage_mod.calculate_linkage(cs, ws, min_snp=20)
    mark("tables_linkage", t)
    n_pairs = int(pairs.mapping_info["filtered_pairs"].iloc[0])
    n_reads = int(pairs.mapping_info["unfiltered_reads"].iloc[0])
    return n_pairs, n_reads, len(snp), len(ld)


def bench_sars():
    from instrain_tpu.profile import compact
    from instrain_tpu.profile.pileup import make_luts
    from instrain_tpu.config import VariantConfig

    refseq = load_ref()
    luts = make_luts(VariantConfig())

    # warmup (compiles kernels; also warms the throttled host's page cache
    # and CPU governor — early native-decode calls run ~20x slow)
    t0 = time.time()
    n_pairs, n_reads, n_snvs, n_ld = run_once_sars(refseq, luts)
    warm = time.time() - t0

    # steady state: best of several UNinstrumented iterations
    steadies = []
    for _ in range(10):
        t0 = time.time()
        run_once_sars(refseq, luts)
        steadies.append(time.time() - t0)
    steady = min(steadies)

    # one extra instrumented run for the phase breakdown: the explicit
    # per-buffer h2d synchronization pays each transfer's latency instead
    # of overlapping it, so breakdown_s sums above the headline steady_s
    # by design
    import bench_util
    ph = {}
    compact.TIMINGS = {}
    spy = bench_util.KernelSpy()
    with spy.active():
        run_once_sars(refseq, luts, phases=ph)
    ph.update(compact.TIMINGS)
    util = bench_util.device_util_summary(
        spy.cost_analyses(), compact.TIMINGS.get("compute", 0.0),
        compact.TIMINGS.get("launches", 0))
    compact.TIMINGS = None

    # second hot kernel: pairwise-linkage LD on device (the pipeline
    # auto-selects host for sars-scale pair counts, so measure the
    # device path explicitly; first call may compile, time the second)
    util_ld = None
    try:
        from instrain_tpu.config import ReadFilterConfig
        from instrain_tpu.io.bam import decode_bam
        from instrain_tpu.io.fasta import seq_to_codes
        from instrain_tpu.profile import linkage as linkage_mod
        from instrain_tpu.profile.filter_reads import filter_reads
        from instrain_tpu.profile.pileup import build_scaffold_pileup_padded
        bam = decode_bam(BAM, ref_seqs={"MT039887.1": refseq}, baq=False)
        prs = filter_reads(bam, ReadFilterConfig())
        pu = build_scaffold_pileup_padded(bam, prs, 0, len(refseq))
        cs = compact.run_site_stats_compact(pu, seq_to_codes(refseq), *luts)
        ws = linkage_mod.window_starts_for(len(refseq), 10000)
        spy2 = bench_util.KernelSpy(
            targets=(("instrain_tpu.kernels.linkage", ("ld_device",)),))
        with spy2.active():
            linkage_mod.calculate_linkage(cs, ws, min_snp=20,
                                          engine="device")
            t0 = time.perf_counter()
            linkage_mod.calculate_linkage(cs, ws, min_snp=20,
                                          engine="device")
            ld_s = time.perf_counter() - t0
        util_ld = bench_util.device_util_summary(
            spy2.cost_analyses(), ld_s, 1)
    except Exception:
        pass

    pairs_per_sec = n_pairs / steady
    return {
        "pairs_per_sec": round(pairs_per_sec, 1),
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 2),
        "filtered_pairs": n_pairs,
        "records": n_reads,
        "snv_rows": n_snvs,
        "linkage_rows": n_ld,
        "warmup_s": round(warm, 2),
        "steady_s": round(steady, 2),
        "steady_all_s": [round(s, 2) for s in steadies],
        "positions_per_sec": round(len(refseq) / steady, 1),
        "reads_per_sec": round(n_reads / steady, 1),
        "breakdown_s": {k: round(v, 4) if isinstance(v, float) else v
                        for k, v in ph.items()},
        "device_util": util,
        "device_util_linkage": util_ld,
    }


def bench_batch_metagenome():
    """Full profile() through the batch engine on a synthetic >=5 Mbp
    multi-scaffold workload (the many-scaffold production path)."""
    import tempfile
    import bench_batch
    import instrain_tpu.profile.pipeline as pl
    from instrain_tpu.profile import compact
    from instrain_tpu.config import ProfileConfig

    workdir = tempfile.mkdtemp(prefix="bench_meta_")
    t0 = time.time()
    fasta, sam, n_pairs = bench_batch.synth(workdir)
    gen_s = time.time() - t0

    # time decode/filter/pileup inside profile() via wrapped entry points
    phases = {}
    orig = {}

    def wrap(name, key):
        fn = getattr(pl, name)
        orig[name] = fn

        def timed(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            phases[key] = phases.get(key, 0.0) + (time.perf_counter() - t0)
            return r
        setattr(pl, name, timed)

    def run(out):
        cfg = ProfileConfig(output=out, skip_plot_generation=True,
                            skip_genome_wide=True)
        cfg.engine = "batch"
        return pl.profile(sam, fasta, cfg)

    t0 = time.time()
    run(os.path.join(workdir, "warm.IS"))
    warm = time.time() - t0

    # UNinstrumented steady runs for the headline number
    steadies = []
    for i in range(3):
        t0 = time.time()
        isdir = run(os.path.join(workdir, f"s{i}.IS"))
        steadies.append(time.time() - t0)
    steady = min(steadies)
    snvs = isdir.get("cumulative_snv_table")

    # one instrumented run for the phase breakdown (synchronized h2d
    # pays per-buffer latency, so the sum exceeds steady_s)
    wrap("decode_bam", "decode")
    wrap("filter_reads", "filter")
    wrap("build_scaffold_pileup_padded", "pileup_build")
    wrap("build_scaffold_pileup", "pileup_build")
    import bench_util
    spy = bench_util.KernelSpy()
    try:
        compact.TIMINGS = {}
        pl.PHASES = phases  # main-thread wall accounting (pipeline.py)
        t0 = time.time()
        with spy.active():
            run(os.path.join(workdir, "instr.IS"))
        phases["instr_wall"] = time.time() - t0
        phases.update(compact.TIMINGS)
        util = bench_util.device_util_summary(
            spy.cost_analyses(), compact.TIMINGS.get("compute", 0.0),
            compact.TIMINGS.get("launches", 0))
    finally:
        for name, fn in orig.items():
            setattr(pl, name, fn)
        compact.TIMINGS = None
        pl.PHASES = None
    return {
        "pairs_per_sec": round(n_pairs / steady, 1),
        "vs_baseline": round(n_pairs / steady / BASELINE_PAIRS_PER_SEC, 2),
        "scaffolds": bench_batch.S,
        "positions": bench_batch.S * bench_batch.L,
        "pairs": n_pairs,
        "snv_rows": 0 if snvs is None else len(snvs),
        "gen_s": round(gen_s, 2),
        "warmup_s": round(warm, 2),
        "steady_s": round(steady, 2),
        "steady_all_s": [round(x, 2) for x in steadies],
        "positions_per_sec": round(bench_batch.S * bench_batch.L / steady,
                                   1),
        "breakdown_s": {k: round(v, 4) if isinstance(v, float) else v
                        for k, v in phases.items()},
        "device_util": util,
    }


def main():
    # persistent compile cache: repeated bench runs skip the first compile
    from instrain_tpu.cache import enable_compile_cache
    enable_compile_cache()

    sars = bench_sars()
    batch = bench_batch_metagenome()

    # compare-stack number (round-4 verdict item 4): E. coli fixture +
    # a synthetic 16-sample sweep with host AND device overlap engines
    try:
        import bench_compare
        compare = {
            "ecoli_fixture": bench_compare.bench_ecoli(),
            "synthetic": bench_compare.bench_synth(
                n_samples=16, n_scaffolds=2, L=1 << 21),
        }
    except Exception as e:  # the headline metrics must still print
        compare = {"error": str(e)}

    result = {
        "metric": "profile_pairs_per_sec",
        "value": sars["pairs_per_sec"],
        "unit": "read pairs/s (end-to-end profile, steady-state)",
        "vs_baseline": sars["vs_baseline"],
        "detail": {
            "bam": os.path.basename(BAM),
            "baseline_pairs_per_sec": round(BASELINE_PAIRS_PER_SEC, 1),
            "sars": sars,
            "batch": batch,
            "compare": compare,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
