#!/usr/bin/env python
"""
Metagenome-scale benchmark: full `profile` over a synthetic multi-scaffold
assembly, exercising the batch engine (vmapped same-bucket kernel
launches + u8 wire format). The sars benchmark (bench.py) measures the
single-scaffold path; this measures the many-scaffold production path.

`synth` writes the workload: S scaffolds x L bp with a planted second
strain and paired reads at COV coverage, as a real BGZF BAM plus its
.bai. It is the one input generator shared by this script, bench.py,
chip_smoke.py and the tests. `main` runs the profile pipeline (warm +
steady) and reports steady-state filtered read pairs/s.

    python bench_batch.py [--cpu]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

S = 128          # scaffolds
L = 40_000       # bp each -> 5.12 Mbp
COV = 30         # target coverage
READ = 150       # read length
INSERT = 300     # outer insert size

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_NIBBLE = np.array([1, 2, 4, 8], np.uint8)   # BAM 4-bit codes of A, C, G, T
_QNAME = 11                                  # "r%09d" + NUL

# One fixed-size BAM record (SAMv1 §4.2): every synthetic read has the
# same length, one M cigar op, a fixed-width name and an NM:i tag, so the
# records assemble as one numpy structured array instead of per-read
# struct packing.
_REC = np.dtype([
    ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
    ("n_cigar_op", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
    ("next_ref_id", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
    ("read_name", f"S{_QNAME}"), ("cigar", "<u4"),
    ("seq", "u1", (READ // 2,)), ("qual", "u1", (READ,)),
    ("tag", "S3"), ("nm", "<i4")])


def _records(ref_id, pos, flag, mate_pos, tlen, codes, nm, qid):
    """Packed BAM records (block_size prefix included) of one scaffold."""
    n = len(pos)
    rec = np.zeros(n, _REC)
    rec["block_size"] = _REC.itemsize - 4
    rec["ref_id"] = ref_id
    rec["pos"] = pos
    rec["l_read_name"] = _QNAME
    rec["mapq"] = 42
    rec["bin"] = 4680
    rec["n_cigar_op"] = 1
    rec["flag"] = flag
    rec["l_seq"] = READ
    rec["next_ref_id"] = ref_id
    rec["next_pos"] = mate_pos
    rec["tlen"] = tlen
    rec["read_name"] = np.char.mod("r%09d", qid).astype(f"S{_QNAME}")
    rec["cigar"] = READ << 4                  # READ x M
    rec["seq"] = (_NIBBLE[codes[:, 0::2]] << 4) | _NIBBLE[codes[:, 1::2]]
    rec["qual"] = 40                          # >= the pileup's min quality 30
    rec["tag"] = b"NMi"
    rec["nm"] = nm
    return rec.tobytes()


def synth(workdir: str, n_scaffolds: int = S, length: int = L,
          coverage: float = COV, seed: int = 7, read_seed=None,
          prefix: str = "synth"):
    """Synthetic metagenome mapping written as a REAL BGZF BAM + .bai.

    The assembly (`n_scaffolds` random scaffolds of `length` bp) and a
    second strain per scaffold (an SNV about every kb) come from `seed`.
    The reads (150 bp pairs, 300 bp inserts, `coverage`x) and the second
    strain's share of each scaffold's templates come from `read_seed`
    (default: `seed`), so two samples of one assembly differ in their
    allele frequencies. Returns (fasta path, bam path, read pairs)."""
    from instrain_tpu.io.bai import make_bai
    from instrain_tpu.io.bgzf import bam_header, write_bgzf
    rng = np.random.default_rng(seed)
    rr = np.random.default_rng(seed if read_seed is None else read_seed)
    fasta = os.path.join(workdir, f"{prefix}.fasta")
    bam = os.path.join(workdir, f"{prefix}.bam")
    n_pairs = int(length * coverage / (2 * READ))
    names = [f"scaf_{s}" for s in range(n_scaffolds)]
    parts = [bam_header([(n, length) for n in names])]
    window = np.arange(READ)
    with open(fasta, "w") as f:
        for s, name in enumerate(names):
            ref = rng.integers(0, 4, length).astype(np.uint8)
            f.write(f">{name}\n{BASES[ref].tobytes().decode()}\n")
            snv = np.sort(rng.choice(length, length // 1000, replace=False))
            alt = ref.copy()
            alt[snv] = (ref[snv] + rng.integers(1, 4, len(snv))) % 4
            n_snv = np.zeros(length + 1, np.int32)
            n_snv[snv + 1] = 1
            n_snv = np.cumsum(n_snv)

            starts = np.sort(rr.integers(0, length - INSERT, n_pairs))
            strain2 = rr.random(n_pairs) < rr.uniform(0.1, 0.6)
            pos = np.concatenate([starts, starts + INSERT - READ])
            two = np.concatenate([strain2, strain2])
            seqs = np.where(two[:, None], alt[pos[:, None] + window],
                            ref[pos[:, None] + window])
            nm = np.where(two, n_snv[pos + READ] - n_snv[pos], 0)
            first = np.arange(2 * n_pairs) < n_pairs
            mate = np.concatenate([starts + INSERT - READ, starts])
            qid = s * n_pairs + np.concatenate([np.arange(n_pairs)] * 2)
            order = np.argsort(pos, kind="stable")
            parts.append(_records(
                s, pos[order], np.where(first, 99, 147)[order],
                mate[order], np.where(first, INSERT, -INSERT)[order],
                seqs[order], nm[order], qid[order]))
    write_bgzf(bam, b"".join(parts), level=1)
    make_bai(bam)
    return fasta, bam, n_scaffolds * n_pairs


def run_once(bam, fasta, out):
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile
    cfg = ProfileConfig(output=out, skip_plot_generation=True,
                        skip_genome_wide=True)
    cfg.engine = "batch"
    return profile(bam, fasta, cfg)


def main():
    import tempfile
    from instrain_tpu.cache import enable_compile_cache
    enable_compile_cache()

    workdir = tempfile.mkdtemp(prefix="bench_batch_")
    t0 = time.time()
    fasta, bam, n_pairs = synth(workdir)
    gen_s = time.time() - t0

    t0 = time.time()
    run_once(bam, fasta, os.path.join(workdir, "warm.IS"))
    warm = time.time() - t0

    steadies = []
    for i in range(3):
        t0 = time.time()
        isdir = run_once(bam, fasta, os.path.join(workdir, f"s{i}.IS"))
        steadies.append(time.time() - t0)
    steady = min(steadies)
    snvs = isdir.get("cumulative_snv_table")

    print(json.dumps({
        "metric": "batch_profile_pairs_per_sec",
        "value": n_pairs / steady,
        "unit": "read pairs/s (end-to-end multi-scaffold profile)",
        "detail": {
            "scaffolds": S, "positions": S * L, "pairs": n_pairs,
            "snv_rows": 0 if snvs is None else len(snvs),
            "gen_s": gen_s, "warmup_s": warm, "steady_s": steady,
            "steady_all_s": steadies,
            "positions_per_sec": S * L / steady,
        },
    }))


if __name__ == "__main__":
    main()
