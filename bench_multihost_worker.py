"""
Worker for bench_multihost.py (a CPU-only simulation): run the REAL
profile() pipeline (warm +
timed steady) as one host of an nproc-process jax.distributed job, and
print one JSON line with the steady wall time and the per-checkpoint
phase segmentation parsed back from the run's own log (obs/logging.py
checkpoint grammar — the reference's runtime-report mechanism,
logUtils.py:85-238).

Run as: python bench_multihost_worker.py <pid> <nproc> <port> <bam>
                                         <fasta> <outbase>
"""

import json
import re
import sys
import time


def phase_times(logpath):
    """Checkpoint name -> seconds (end - start) from the profile log."""
    pat = re.compile(r"^(\d\d-\d\d-\d\d \d\d:\d\d:\d\d).*Checkpoint "
                     r"main_profile (\S+) (start|end)")
    marks = {}
    for line in open(logpath):
        m = pat.match(line)
        if not m:
            continue
        t = time.mktime(time.strptime(m.group(1), "%y-%m-%d %H:%M:%S"))
        marks.setdefault(m.group(2), {})[m.group(3)] = t
    return {k: round(v["end"] - v["start"], 2) for k, v in marks.items()
            if "start" in v and "end" in v}


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    bam, fasta, outbase = sys.argv[4:7]

    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc, process_id=pid)

    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile

    import instrain_tpu.profile.pipeline as pl
    import instrain_tpu.profile.filter_reads as fr
    import instrain_tpu.parallel.distributed as dist

    extra = {}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def timed(*a, **k):
            t0 = time.time()
            r = fn(*a, **k)
            extra[key] = extra.get(key, 0.0) + time.time() - t0
            return r
        setattr(mod, name, timed)

    wrap(pl, "decode_bam", "decode")
    wrap(fr, "filter_reads_distributed", "filter_dist")
    wrap(pl, "filter_reads", "filter")
    wrap(dist, "allgather_tables", "allgather")

    def run(tag):
        cfg = ProfileConfig(output=f"{outbase}.{tag}.IS",
                            skip_plot_generation=True,
                            skip_genome_wide=True)
        # the production multi-host engine: vmapped per-bucket
        # launches + streaming hd5 writes
        cfg.engine = "batch"
        pl.PHASES = fine = {}
        extra.clear()
        if nproc > 1:
            # align the clocks: the workers spawn staggered (serial
            # 1 s starts) and drift through warmup, so an unaligned
            # steady run charges the skew wait at the first collective
            # to the measured wall
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices(f"steady:{tag}")
        t0 = time.time()
        isdir = profile(bam, fasta, cfg)
        pl.PHASES = None
        fine.update(extra)
        return time.time() - t0, isdir, fine

    run("warm")
    runs = [run(f"steady{i}") for i in range(2)]
    steady, isdir, fine = min(runs, key=lambda r: r[0])
    print(json.dumps({
        "pid": pid, "nproc": nproc, "steady_s": round(steady, 2),
        "phases": phase_times(isdir.get_location("log") + "log.log"),
        "fine_s": {k: round(v, 3) for k, v in fine.items()
                   if isinstance(v, float)},
    }), flush=True)


if __name__ == "__main__":
    main()
