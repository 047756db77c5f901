"""
io/bai.py: minimal .bai writer + header/extent readers, and the
distributed filter's histogram median (profile/filter_reads.py).
"""

import os

import numpy as np
import pytest

D = "/root/reference/test/test_data/"


def test_median_from_hist_matches_np_median():
    from instrain_tpu.profile.filter_reads import _median_from_hist
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 10, 101, 1000):
        arr = rng.integers(-50, 5000, n)
        vals, cnts = np.unique(arr, return_counts=True)
        # split the histogram across 3 "hosts" and merge unsorted
        parts = np.array_split(np.arange(len(vals)), 3)
        g_vals = np.concatenate([vals[p] for p in reversed(parts)])
        g_cnts = np.concatenate([cnts[p] for p in reversed(parts)])
        got = _median_from_hist(g_vals, g_cnts)
        assert got == np.median(arr), n
    assert np.isnan(_median_from_hist(np.zeros(0, np.int64),
                                      np.zeros(0, np.int64)))


def test_make_bai_ranged_decode_parity(tmp_path):
    """A make_bai index on a synthesized BAM must drive the native
    ranged decoder to the exact records a full decode holds."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench_batch
    from instrain_tpu.io.bai import (find_bai, make_bai,
                                     read_bam_ref_names,
                                     read_ref_extents)
    from instrain_tpu.io.bam import decode_bam

    fasta, bam_path, _ = bench_batch.synth(str(tmp_path), n_scaffolds=5,
                                           length=6000)

    bai = find_bai(bam_path)
    assert bai and os.path.exists(bai)  # synth writes it via make_bai
    names = read_bam_ref_names(bam_path)
    assert names == [f"scaf_{i}" for i in range(5)]
    ext = read_ref_extents(bai)
    assert len(ext) == 5 and (ext > 0).all()

    full = decode_bam(bam_path)
    sub = decode_bam(bam_path, scaffolds=["scaf_0", "scaf_3"])
    assert sub.ranged
    for name in ("scaf_0", "scaf_3"):
        a = full.records_of_ref(full.name_to_ref_id[name])
        b = sub.records_of_ref(sub.name_to_ref_id[name])
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(full.pos[a], sub.pos[b])
        np.testing.assert_array_equal(full.nm[a], sub.nm[b])
        np.testing.assert_array_equal(full.mapq[a], sub.mapq[b])


def test_read_extents_real_fixture():
    bai = D + "N5_271_010G1_scaffold_min1000.fa-vs-N5_271_010G1.sorted.bam.bai"
    if not os.path.exists(bai):
        pytest.skip("fixture missing")
    from instrain_tpu.io.bai import read_ref_extents
    ext = read_ref_extents(bai)
    assert len(ext) == 178 and (ext > 0).all()


def test_read_bam_ref_names_real_fixture():
    # only the .sub subsample BAM ships for the N5 multi-scaffold set
    bam = (D +
           "N5_271_010G1_scaffold_min1000.fa-vs-N5_271_010G1.sorted.bam.sub")
    if not os.path.exists(bam):
        pytest.skip("fixture missing")
    from instrain_tpu.io.bai import read_bam_ref_names
    from instrain_tpu.io.bam import decode_bam
    names = read_bam_ref_names(bam)
    assert len(names) == 178
    assert names == list(decode_bam(bam).ref_names)
