#!/usr/bin/env python
"""
Smoke run on the GPU: profile and compare end to end, each checked
against the plain path on the CPU backend of the same process.

    python chip_smoke.py [--seed N]        # one GPU
    python chip_smoke.py --multi [--seed N]  # four GPUs of one host

Inputs are generated from --seed (bench_batch.synth writes a BGZF BAM and
its .bai); the analytic null model is used. Phases:

  profile_batch   128 scaffolds x 40 kb at 30x; `--engine auto` must pick
                  the batch engine and run its sparse-wire kernel.
  profile_hybrid  4 scaffolds x 1 Mbp at 30x; auto must pick hybrid.
  linkage         phase 2's scaffolds: linkage on the device against the
                  host engine.
  compare         a second sample of phase 1's assembly; the overlap
                  counts on the device against the host engine.

Profiles are compared with `--engine dense` run on the CPU. They are
computed as `profile` computes them, stopping before the profile
directory is written (profile_scaffolds), so that no h5py is needed.
Rules (the repo's engine-parity tests): integer, boolean and string
columns exactly; f32 clonality values and nucl_diversity* means to rtol
1e-6 (f32 on the dense path against f64 sums on the device path); every
other float to rtol 1e-9; NaN in the same places. Any mismatch, a kernel
that did not run, or a FAILURE line in the log fails the run.

--multi runs only the two profile inputs with --mesh_devices 4 (scaffold
axis sharded for the batch engine, position axis for hybrid) and
requires them to equal the 1-device run bit for bit.

Each phase prints one line; the last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
The script exits non-zero, before printing that line, when JAX finds no
GPU or any check fails.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import namedtuple

ROOT = os.path.dirname(os.path.abspath(__file__))

# (scaffolds, bp each, coverage) of the two profile inputs
Sizes = namedtuple("Sizes", "batch hybrid")
FULL = Sizes(batch=(128, 40_000, 30), hybrid=(4, 1_000_000, 30))

F32_RTOL = 1e-6   # f32 on the dense path against f64 sums on the device
RTOL = 1e-9       # everything else that is not an integer
# the rarefied linkage columns are drawn by a different generator on the
# device (counter-based) than on the host (numpy), so they are not compared
LINKAGE_RAREFIED = ("r2_normalized", "d_prime_normalized")


class Mismatch(AssertionError):
    pass


def _rtol(column: str) -> float:
    f32 = column.startswith("nucl_diversity") or column in ("clonT",
                                                            "clonTR")
    return F32_RTOL if f32 else RTOL


def _same_values(a, b, what: str, rtol: float, worst: dict):
    """Exact for integer/bool/str values, `rtol` (with atol = rtol, as in
    the repo's parity tests) for floats, NaN in the same places; rtol 0
    asks floats to be equal bit for bit. Records the largest relative
    float difference, absolute and relative, under `what`'s column name
    in `worst`."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise Mismatch(f"{what}: shape {a.shape} != {b.shape}")
    if a.dtype.kind in "fc" or b.dtype.kind in "fc":
        a, b = a.astype(np.float64), b.astype(np.float64)
        na, nb = np.isnan(a), np.isnan(b)
        if not np.array_equal(na, nb):
            raise Mismatch(f"{what}: NaN at {int((na != nb).sum())} "
                           f"different places")
        a, b = a[~na], b[~na]
        if len(a):
            diff = np.abs(a - b)
            scale = np.maximum(np.abs(a), np.abs(b))
            rel = float(np.max(np.where(scale > 0, diff / np.where(
                scale > 0, scale, 1), 0)))
            col = what.rsplit(".", 1)[-1]
            old = worst.get(col, (0.0, 0.0))
            worst[col] = (max(old[0], float(diff.max())), max(old[1], rel))
            ok = (np.array_equal(a, b) if rtol == 0 else
                  np.allclose(a, b, rtol=rtol, atol=rtol))
            if not ok:
                raise Mismatch(f"{what}: max difference {diff.max():.3g} "
                               f"(relative {rel:.3g}) over rtol {rtol:g}")
    elif a.dtype.kind == "O" or b.dtype.kind == "O":
        if [str(x) for x in a] != [str(x) for x in b]:
            raise Mismatch(f"{what}: values differ")
    elif not np.array_equal(a, b):
        raise Mismatch(f"{what}: {int((a != b).sum())} values differ")


def compare_frames(ref, got, what: str, exact: bool = False, skip=(),
                   worst=None) -> int:
    """Compare two tables row set by row set (rows sorted by every
    non-float column); returns the row count."""
    worst = {} if worst is None else worst
    if len(ref) == 0 and len(got) == 0:
        return 0
    if list(ref.columns) != list(got.columns):
        raise Mismatch(f"{what}: columns {list(ref.columns)} != "
                       f"{list(got.columns)}")
    if len(ref) != len(got):
        raise Mismatch(f"{what}: {len(ref)} rows != {len(got)}")
    keys = [c for c in ref.columns if ref[c].dtype.kind not in "fc"]
    if keys:
        ref = ref.sort_values(keys, kind="mergesort")
        got = got.sort_values(keys, kind="mergesort")
    ref, got = ref.reset_index(drop=True), got.reset_index(drop=True)
    for c in ref.columns:
        if c not in skip:
            _same_values(ref[c].values, got[c].values, f"{what}.{c}",
                         0.0 if exact else _rtol(c), worst)
    return len(ref)


def _compare_views(ref: dict, got: dict, what: str, exact: bool,
                   worst: dict):
    """covT / clonT / clonTR: mm -> position-indexed Series."""
    if set(ref) != set(got):
        raise Mismatch(f"{what}: mm levels {sorted(ref)} != {sorted(got)}")
    for mm in ref:
        _same_values(ref[mm].index.values, got[mm].index.values,
                     f"{what}[{mm}].index", 0.0, worst)
        _same_values(ref[mm].values, got[mm].values, f"{what}[{mm}]",
                     0.0 if exact else _rtol(what.rsplit(".", 1)[-1]),
                     worst)


def compare_payloads(ref_finals, got_finals, exact: bool = False) -> dict:
    """Compare two profiles as profile_scaffolds returns them: every
    table, the covT/clonT/clonTR views and the linkage capture of every
    scaffold. Returns row counts and the largest (absolute, relative)
    difference of each float column; raises Mismatch on the first
    difference."""
    ref = {f["name"]: f for f in ref_finals}
    got = {f["name"]: f for f in got_finals}
    if set(ref) != set(got):
        raise Mismatch(f"scaffolds differ: {sorted(set(ref) ^ set(got))}")
    rows = {"snv_rows": 0, "snp_rows": 0, "linkage_rows": 0,
            "scaffold_rows": 0}
    worst: dict = {}
    for name in sorted(ref):
        r, g = ref[name], got[name]
        for key, table in (("snv_rows", "cumulative_snv_table"),
                           ("snp_rows", "snp_table"),
                           ("linkage_rows", "linkage_table"),
                           ("scaffold_rows", "cumulative_scaffold_table")):
            rows[key] += compare_frames(r[table], g[table],
                                        f"{name}.{table}", exact,
                                        worst=worst)
        for view in ("covT", "clonT", "clonTR"):
            _compare_views(r[view], g[view], f"{name}.{view}", exact, worst)
        if r["reads_to_snvs"] != g["reads_to_snvs"]:
            raise Mismatch(f"{name}: linkage read capture differs")
    rows["scaffolds"] = len(ref)
    rows["max_diff"] = worst
    return rows


def profile_payloads(bam: str, fasta: str, engine: str = "auto",
                     mesh_devices: int = 0):
    """(engine, per-scaffold payloads) of `profile` on its default
    options, with the plots and genome-wide tables skipped."""
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile_scaffolds
    cfg = ProfileConfig(skip_plot_generation=True, skip_genome_wide=True)
    cfg.engine = engine
    cfg.mesh_devices = mesh_devices
    return profile_scaffolds(bam, fasta, cfg)


class _Spy:
    """Counts the calls of a module-level function, and keeps the first
    call's arguments: shapes for the positional (array) ones, the static
    keyword ones as they were."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls, self.first = module, name, 0, None

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            if self.first is None:
                import jax
                import numpy as np
                self.first = (tuple(jax.ShapeDtypeStruct(np.shape(a),
                                                         a.dtype)
                                    for a in args), dict(kwargs))
            self.calls += 1
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


class _Failures(logging.Handler):
    """Collects the pipeline's FAILURE log lines (obs.logging.log_failure):
    the batch engine retries a failed launch on the per-scaffold path, and
    that retry must not hide a kernel that failed on the device."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if " FAILURE " in msg:
            self.lines.append(msg)


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


class Smoke:
    def __init__(self, workdir: str, seed: int, sizes: Sizes, card: str):
        import jax
        self.workdir, self.seed, self.sizes, self.card = (workdir, seed,
                                                          sizes, card)
        self.dev = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]

    def report(self, phase: str, **info):
        info["card"] = self.card
        print(f"phase {phase}: {json.dumps(info, default=float)}",
              flush=True)

    def synth(self, size, seed, read_seed, prefix):
        import bench_batch
        (fasta, bam, pairs), s = _timed(
            bench_batch.synth, self.workdir, *size, seed=seed,
            read_seed=read_seed, prefix=prefix)
        return fasta, bam, pairs, s

    def profile(self, phase, size, seed, want_engine, kernel):
        """Profile one input on the GPU (twice: warm, then steady) and on
        the CPU with the dense engine; returns the GPU payloads."""
        import jax
        import instrain_tpu.kernels.sitestats as K
        fasta, bam, pairs, gen_s = self.synth(size, seed, seed, phase)
        with _Spy(K, kernel) as spy, jax.default_device(self.dev):
            (engine, got), warm = _timed(profile_payloads, bam, fasta)
            (_, again), steady = _timed(profile_payloads, bam, fasta)
        if engine != want_engine:
            raise Mismatch(f"{phase}: auto picked {engine}, not "
                           f"{want_engine}")
        if not spy.calls:
            raise Mismatch(f"{phase}: kernel {kernel} never ran")
        with jax.default_device(self.cpu):
            (_, ref), cpu_s = _timed(profile_payloads, bam, fasta,
                                     engine="dense")
        counts = compare_payloads(ref, got)
        compare_payloads(ref, again)
        self.report(phase, checked=f"{engine} engine on {self.dev.platform}"
                    f" == dense engine on cpu", engine=engine,
                    kernel=kernel, kernel_calls=spy.calls,
                    pairs=pairs, **counts, synth_s=gen_s, warm_s=warm,
                    steady_s=steady, cpu_dense_s=cpu_s)
        return fasta, bam, got, spy

    def batch_kernel_memory(self, spy):
        """memory_analysis() of the batch kernel at phase 1's first launch
        shape, and its compile time with the persistent cache off."""
        import jax
        import instrain_tpu.kernels.sitestats as K
        args, kwargs = spy.first
        jax.clear_caches()       # or compile() returns the jit's executable
        jax.config.update("jax_enable_compilation_cache", False)
        try:
            compiled, cold = _timed(lambda: K.site_stats_compact_batch_sparse
                                    .lower(*args, **kwargs).compile())
        finally:
            jax.config.update("jax_enable_compilation_cache", True)
        ma = compiled.memory_analysis()
        self.report("batch_kernel_memory",
                    shape=kwargs["shape"],
                    scaffolds_per_launch=args[0].shape[0],
                    argument_bytes=ma.argument_size_in_bytes,
                    output_bytes=ma.output_size_in_bytes,
                    temp_bytes=ma.temp_size_in_bytes,
                    generated_code_bytes=ma.generated_code_size_in_bytes,
                    cold_compile_s=cold)

    def linkage(self, fasta, bam):
        """Linkage of every scaffold: ld_device on the GPU against the
        host engine."""
        import jax
        import instrain_tpu.kernels.linkage as KL
        from instrain_tpu.config import ProfileConfig
        from instrain_tpu.profile import compact
        from instrain_tpu.profile.linkage import (calculate_linkage,
                                                  window_starts_for)
        from instrain_tpu.profile.pileup import (
            build_scaffold_pileup_padded, make_luts)
        from instrain_tpu.profile.pipeline import _read_and_filter
        cfg = ProfileConfig()
        registry, bam_a, pairs, _ = _read_and_filter(bam, fasta, cfg)
        null_lut, freq_lut = make_luts(cfg.variant)
        stats = []
        with jax.default_device(self.dev):
            for name in registry.names:
                pu = build_scaffold_pileup_padded(
                    bam_a, pairs, bam_a.name_to_ref_id[name],
                    registry.length_of(name))
                stats.append((name, compact.run_site_stats_hybrid(
                    pu, registry.codes[name], null_lut, freq_lut,
                    seed=cfg.seed)))

        def run(engine):
            out = {}
            for name, st in stats:
                ws = window_starts_for(st.pileup.length, cfg.window_length)
                out[name] = calculate_linkage(st, ws, min_snp=cfg.min_snp,
                                              seed=cfg.seed, engine=engine)
            return out

        with _Spy(KL, "ld_device") as spy, jax.default_device(self.dev):
            dev, warm = _timed(run, "device")
            _, steady = _timed(run, "device")
        if not spy.calls:
            raise Mismatch("linkage: ld_device never ran")
        with jax.default_device(self.cpu):
            host, cpu_s = _timed(run, "host")
        worst: dict = {}
        rows = sum(compare_frames(host[n], dev[n], f"{n}.linkage",
                                  skip=LINKAGE_RAREFIED, worst=worst)
                   for n in host)
        if not rows:
            raise Mismatch("linkage: no linkage rows to compare")
        self.report("linkage", checked="ld_device on "
                    f"{self.dev.platform} == host engine (rarefied columns "
                    "not compared)", linkage_rows=rows,
                    ld_device_calls=spy.calls, scaffolds=len(host),
                    max_diff=worst, warm_s=warm, steady_s=steady,
                    host_s=cpu_s)

    def compare(self, fasta, bam_a, fin_a):
        """A second sample of phase 1's assembly, profiled on the GPU;
        then every shared scaffold compared with the overlap counted on
        the device and on the host."""
        import jax
        import pandas as pd
        import instrain_tpu.kernels.compare as KC
        from instrain_tpu.compare.pipeline import (SampleScaffoldData,
                                                   ScaffoldComparison,
                                                   compare_scaffold,
                                                   snvs_by_scaffold)
        from instrain_tpu.config import CompareConfig
        from instrain_tpu.kernels.nullmodel import null_thresholds
        from instrain_tpu.kernels.sitestats import freq_min_count_lut
        _, bam_b, pairs_b, gen_s = self.synth(self.sizes.batch, self.seed,
                                              self.seed + 1, "compare")
        with jax.default_device(self.dev):
            _, fin_b = profile_payloads(bam_b, fasta)
        names = [os.path.basename(bam_a), os.path.basename(bam_b)]
        samples = []
        for fin in (fin_a, fin_b):
            snvs = snvs_by_scaffold(pd.concat(
                [f["cumulative_snv_table"] for f in fin
                 if len(f["cumulative_snv_table"])]))
            samples.append({f["name"]: SampleScaffoldData(
                covT=f["covT"], snp=snvs.get(f["name"], pd.DataFrame()))
                for f in fin})
        length = {f["name"]: f["length"] for f in fin_a}
        shared = sorted(set(samples[0]) & set(samples[1]))
        cc = CompareConfig()
        null_lut = null_thresholds(cc.null_model, fdr=cc.fdr)
        freq_lut = freq_min_count_lut(cc.min_freq)

        def run(engine):
            cfg = CompareConfig(engine=engine)
            return pd.concat([compare_scaffold(
                ScaffoldComparison(s, length[s], names=list(names)),
                null_lut, freq_lut, cfg,
                datas=[samples[0][s], samples[1][s]])[0] for s in shared],
                ignore_index=True)

        with _Spy(KC, "_overlap_counts_device") as spy, \
                jax.default_device(self.dev):
            dev, warm = _timed(run, "device")
            _, steady = _timed(run, "device")
        if not spy.calls:
            raise Mismatch("compare: the device overlap kernel never ran")
        with jax.default_device(self.cpu):
            host, cpu_s = _timed(run, "host")
        worst: dict = {}
        rows = compare_frames(host, dev, "comparisonsTable", worst=worst)
        if not rows or not (dev["compared_bases_count"] > 0).all():
            raise Mismatch("compare: no overlapping positions compared")
        self.report("compare", checked="overlap einsum on "
                    f"{self.dev.platform} == host popcount", pairs=pairs_b,
                    scaffold_pairs=len(shared), comparison_rows=rows,
                    max_diff=worst, synth_s=gen_s, warm_s=warm,
                    steady_s=steady, host_s=cpu_s)

    def run(self):
        fasta, bam, fin_a, spy = self.profile(
            "profile_batch", self.sizes.batch, self.seed, "batch",
            "site_stats_compact_batch_sparse")
        self.batch_kernel_memory(spy)
        fasta_h, bam_h, _, _ = self.profile(
            "profile_hybrid", self.sizes.hybrid, self.seed + 2, "hybrid",
            "site_stats_compact_sparse")
        self.linkage(fasta_h, bam_h)
        self.compare(fasta, bam, fin_a)

    def run_multi(self, n: int = 4):
        """1-device against n-device runs of both profile inputs."""
        import jax
        if len(jax.devices()) < n:
            raise Mismatch(f"--multi needs {n} devices, found "
                           f"{len(jax.devices())}")
        for phase, size, seed, want in (
                ("multi_batch", self.sizes.batch, self.seed, "batch"),
                ("multi_hybrid", self.sizes.hybrid, self.seed + 2,
                 "hybrid")):
            fasta, bam, pairs, gen_s = self.synth(size, seed, seed, phase)
            (e1, one), one_s = _timed(profile_payloads, bam, fasta)
            (en, many), warm = _timed(profile_payloads, bam, fasta,
                                      mesh_devices=n)
            _, steady = _timed(profile_payloads, bam, fasta,
                               mesh_devices=n)
            if not e1 == en == want:
                raise Mismatch(f"{phase}: engines {e1}, {en}, not {want}")
            counts = compare_payloads(one, many, exact=True)
            self.report(phase, checked=f"{want} engine on {n} devices == "
                        "1 device, bit for bit", devices=n, pairs=pairs,
                        **counts, one_device_s=one_s, warm_s=warm,
                        steady_s=steady)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated input")
    ap.add_argument("--multi", action="store_true",
                    help="only the 4-GPU sharded profiles against 1 GPU")
    args = ap.parse_args(argv)

    # fail instead of quietly running on the CPU; the CPU backend of the
    # same process serves only as the reference
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is "
                         f"{jax.default_backend()}")
    sys.path.insert(0, ROOT)
    from instrain_tpu.cache import enable_compile_cache
    from instrain_tpu.io.bam import _load_lib

    _, build_s = _timed(_load_lib)       # builds native/ on first use
    cache = enable_compile_cache()
    card = card_info()
    print(card, flush=True)
    print(f"setup: native decoder ready in {build_s:.3f} s, compile cache "
          f"{cache}", flush=True)

    failures = _Failures()
    root = logging.getLogger()
    root.addHandler(failures)
    root.setLevel(logging.DEBUG)         # log_failure writes at DEBUG
    logging.getLogger("jax").setLevel(logging.WARNING)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        smoke = Smoke(workdir, args.seed, FULL, card)
        if args.multi:
            smoke.run_multi()
        else:
            smoke.run()
    finally:
        root.removeHandler(failures)
        shutil.rmtree(workdir, ignore_errors=True)
    if failures.lines:
        raise SystemExit("FAILURE lines in the log:\n" +
                         "\n".join(failures.lines))
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
