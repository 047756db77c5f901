#!/usr/bin/env python
"""
Scaffold-count scaling sweep on the device:
filtered-pairs/s through the full profile() batch engine at
S = 1 / 16 / 64 / 256 scaffolds (40 kb each, ~30x coverage), so the
launch-vs-compute balance of the many-scaffold production path is
measurable. The reference's equivalent knob is its process-pool size
(inStrain profile/profile_controller.py:157-193).

Prints one JSON line per S plus a final summary line. ONE process,
sequential runs, min-over-repeats.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: F401,E402

SWEEP = [int(s) for s in os.environ.get(
    "INSTRAIN_SWEEP_S", "1,16,64,256").split(",")]
REPEATS = int(os.environ.get("INSTRAIN_SWEEP_REPEATS", "3"))


def main():
    from instrain_tpu.cache import enable_compile_cache
    enable_compile_cache()

    import bench_batch
    import instrain_tpu.profile.pipeline as pl
    from instrain_tpu.config import ProfileConfig

    rows = []
    for S in SWEEP:
        workdir = tempfile.mkdtemp(prefix=f"sweep_{S}_")
        fasta, bam, n_pairs = bench_batch.synth(workdir, n_scaffolds=S)

        def run(out):
            cfg = ProfileConfig(output=out, skip_plot_generation=True,
                                skip_genome_wide=True)
            cfg.engine = "batch"
            return pl.profile(bam, fasta, cfg)

        t0 = time.time()
        run(os.path.join(workdir, "warm.IS"))
        warm = time.time() - t0
        steadies, iter_phases = [], []
        for i in range(REPEATS):
            # per-iteration phase accounting so a stalled iteration is
            # attributable (min-of-N would hide it; the in-run stall
            # watchdog also logs it live)
            ph = {}
            pl.PHASES = ph
            t0 = time.time()
            try:
                run(os.path.join(workdir, f"s{i}.IS"))
            finally:
                pl.PHASES = None
            steadies.append(time.time() - t0)
            iter_phases.append({k: round(v, 2) for k, v in ph.items()})
        steady = min(steadies)
        row = {
            "scaffolds": S,
            "positions": S * bench_batch.L,
            "pairs": n_pairs,
            "pairs_per_sec": round(n_pairs / steady, 1),
            "warmup_s": round(warm, 2),
            "steady_s": round(steady, 2),
            "steady_all_s": [round(x, 2) for x in steadies],
            "steady_phases": iter_phases,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(json.dumps({"metric": "scaffold_scaling",
                      "unit": "read pairs/s vs scaffold count",
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
