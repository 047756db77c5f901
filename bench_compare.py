#!/usr/bin/env python
"""
Compare-stack benchmark: the product's second pipeline
(profile-vs-profile conANI/popANI) finally gets a throughput number
(round-4 verdict item 4).

Two workloads:
1. real fixture: the E. coli mutated-ANI profile pair from the
   reference's test_data (compare_scaffold oracle-exact in tests).
2. synthetic N-sample sweep: N profiles over S scaffolds x L bp with
   planted SNVs, run once with the host (u64 popcount) overlap engine
   and once with the device (bf16 bit-matmul) engine
   (kernels/compare.py). Reported per engine: total wall and the
   overlap-stage wall; pairs_per_sec = scaffold-pair-comparisons/s.

Standalone: `python bench_compare.py [--cpu]` prints one JSON line.
bench.py embeds a smaller config into its detail.
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

D = "/root/reference/test/test_data/"
ECOLI = (D + "Ecoli_ani.100.0.subset.sorted.bam.IS",
         D + "Ecoli_ani.99.9.subset.sorted.bam.IS",
         D + "Ecoli_ani.98.0.subset.sorted.bam.IS")

BASES = np.array(list("ACTG"))


def synth_profiles(workdir, n_samples, n_scaffolds, L, seed=11):
    """N minimal profile dirs (covT special + cumulative_snv_table) with
    ~30x coverage over 3 mm levels and planted SNVs (~1/500 bp)."""
    import pandas as pd
    from instrain_tpu.store.profile_dir import ProfileDir

    rng = np.random.default_rng(seed)
    scaffolds = [f"cs_{i}" for i in range(n_scaffolds)]
    paths = []
    for si in range(n_samples):
        loc = os.path.join(workdir, f"sample_{si}.IS")
        prof = ProfileDir(loc)
        covt = {}
        snv_rows = []
        for s in scaffolds:
            mm2cov = {}
            base_cov = rng.integers(8, 40)
            for mm in (0, 2, 4):
                # most positions covered; breadth ~0.9
                mask = rng.random(L) < 0.9
                vals = np.full(mask.sum(), base_cov // 3 + 1, np.int32)
                mm2cov[mm] = pd.Series(
                    vals, index=np.flatnonzero(mask).astype(np.int64))
            covt[s] = mm2cov
            pos = np.sort(rng.choice(L, L // 500, replace=False))
            refb = BASES[rng.integers(0, 4, len(pos))]
            conb = BASES[rng.integers(0, 4, len(pos))]
            counts = rng.integers(0, 20, (len(pos), 4))
            snv_rows.append(pd.DataFrame({
                "scaffold": s, "position": pos,
                "ref_base": refb, "con_base": conb,
                "var_base": BASES[rng.integers(0, 4, len(pos))],
                "A": counts[:, 0], "C": counts[:, 1],
                "T": counts[:, 2], "G": counts[:, 3],
                "position_coverage": counts.sum(axis=1) + 5,
                "allele_count": rng.integers(1, 3, len(pos)),
                "mm": rng.choice([0, 2, 4], len(pos)),
            }))
        prof.store("object_type", "profile", "value", "type")
        prof.store("bam_loc", f"sample_{si}.bam", "value", "bam")
        prof.store("scaffold2length", {s: L for s in scaffolds},
                   "dictionary", "lengths")
        prof.store("covT", covt, "special", "coverage")
        prof.store("cumulative_snv_table",
                   (pd.concat(snv_rows).sort_values(["scaffold", "mm"])
                    .reset_index(drop=True)),
                   "pandas", "snvs")
        paths.append(loc)
    return paths, scaffolds


def run_compare(paths, out, engine):
    from instrain_tpu.compare import pipeline as cp
    from instrain_tpu.config import CompareConfig
    cfg = CompareConfig(output=out, skip_plot_generation=True,
                        engine=engine)
    t0 = time.time()
    cp.compare(paths, cfg)
    return time.time() - t0


def bench_synth(n_samples=16, n_scaffolds=4, L=1 << 21, engines=("host",
                                                                 "device")):
    from instrain_tpu.compare import pipeline as cp
    from instrain_tpu.kernels import compare as kc

    workdir = tempfile.mkdtemp(prefix="bench_cmp_")
    t0 = time.time()
    paths, scaffolds = synth_profiles(workdir, n_samples, n_scaffolds, L)
    gen_s = time.time() - t0
    n_pairs = n_samples * (n_samples - 1) // 2 * n_scaffolds

    out = {"n_samples": n_samples, "n_scaffolds": n_scaffolds, "L": L,
           "scaffold_pairs": n_pairs, "gen_s": round(gen_s, 2)}
    for engine in engines:
        # time the overlap-count stage separately via wrapped kernels
        stage = {"s": 0.0}
        orig_h, orig_d = (kc.pairwise_overlap_counts_host,
                          kc.pairwise_overlap_counts_device)

        def timed(fn):
            def wrap(*a, **k):
                t0 = time.perf_counter()
                r = fn(*a, **k)
                stage["s"] += time.perf_counter() - t0
                return r
            return wrap
        kc.pairwise_overlap_counts_host = timed(orig_h)
        kc.pairwise_overlap_counts_device = timed(orig_d)
        try:
            walls = []
            for it in range(2):
                stage["s"] = 0.0
                walls.append(run_compare(
                    paths, os.path.join(workdir, f"{engine}{it}.RC"),
                    engine))
            wall = min(walls)
        finally:
            kc.pairwise_overlap_counts_host = orig_h
            kc.pairwise_overlap_counts_device = orig_d
        out[engine] = {
            "wall_s": round(wall, 2),
            "walls_s": [round(w, 2) for w in walls],
            "overlap_stage_s": round(stage["s"], 2),
            "scaffold_pairs_per_sec": round(n_pairs / wall, 1),
            "positions_per_sec": round(
                n_pairs * L / wall, 1),
        }
    # cross-engine equality of the comparisons table
    import pandas as pd
    from instrain_tpu.store.profile_dir import ProfileDir
    if all(e in out for e in ("host", "device")):
        a = ProfileDir(os.path.join(workdir, "host1.RC")).get(
            "comparisonsTable")
        b = ProfileDir(os.path.join(workdir, "device1.RC")).get(
            "comparisonsTable")
        key = ["scaffold", "name1", "name2", "mm"]
        pd.testing.assert_frame_equal(
            a.sort_values(key).reset_index(drop=True),
            b.sort_values(key).reset_index(drop=True))
        out["engines_identical"] = True
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def bench_ecoli():
    if not all(os.path.exists(p) for p in ECOLI):
        return None
    workdir = tempfile.mkdtemp(prefix="bench_cmp_ec_")
    walls = []
    for it in range(3):
        walls.append(run_compare(list(ECOLI),
                                 os.path.join(workdir, f"ec{it}.RC"),
                                 "auto"))
    from instrain_tpu.store.profile_dir import ProfileDir
    ct = ProfileDir(os.path.join(workdir, "ec2.RC")).get(
        "comparisonsTable")
    out = {"wall_s": round(min(walls), 2),
           "walls_s": [round(w, 2) for w in walls],
           "rows": 0 if ct is None else len(ct)}
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def main():
    from instrain_tpu.cache import enable_compile_cache
    enable_compile_cache()
    result = {
        "metric": "compare_scaffold_pairs_per_sec",
        "ecoli_fixture": bench_ecoli(),
        "synthetic": bench_synth(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
