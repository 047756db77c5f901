"""
Compare-stack tests: oracle comparison against the reference's
compare_scaffold on the E. coli mutated-ANI profiles, plus the reference's
own self-comparison invariants (test_compare.py:31-131 in the reference).
"""

import os

import numpy as np
import pandas as pd
import pytest

from instrain_tpu.compare.pipeline import (ScaffoldComparison,
                                           compare_scaffold)
from instrain_tpu.config import CompareConfig
from instrain_tpu.kernels.nullmodel import null_thresholds
from instrain_tpu.kernels.sitestats import freq_min_count_lut
from instrain_tpu.store.profile_dir import ProfileDir
from reference_oracle import import_reference

D = "/root/reference/test/test_data/"
ECOLI = [D + "Ecoli_ani.100.0.subset.sorted.bam.IS",
         D + "Ecoli_ani.99.9.subset.sorted.bam.IS",
         D + "Ecoli_ani.98.0.subset.sorted.bam.IS"]

RENAME = {"conBase": "con_base", "refBase": "ref_base",
          "varBase": "var_base", "baseCoverage": "position_coverage"}


@pytest.fixture(scope="module")
def luts(ref_null_model):
    return (null_thresholds(ref_null_model, fdr=1e-6),
            freq_min_count_lut(0.05))


@pytest.fixture(scope="module")
def oracle(ref_null_model):
    rc = import_reference("inStrain.readComparer")
    snvu = import_reference("inStrain.profile.snv_utilities")
    model = snvu.generate_snp_model(ref_null_model, fdr=1e-6)
    return rc, model


def _profiles():
    for p in ECOLI:
        if not os.path.exists(p):
            pytest.skip("Ecoli fixtures unavailable")
    return [ProfileDir(p) for p in ECOLI]


def _snp_for(prof, scaff):
    db = prof.get("cumulative_snv_table").rename(columns=RENAME)
    if len(db):
        db = db[db["scaffold"] == scaff].sort_values("mm")
    return db


@pytest.mark.parametrize("i,j", [(0, 1), (0, 2), (1, 2), (0, 0)])
def test_compare_pair_matches_oracle(luts, oracle, i, j, ref_null_model):
    null_lut, freq_lut = luts
    rc, model = oracle
    profs = _profiles()
    p1, p2 = profs[i], profs[j]
    s2l = p1.get("scaffold2length")
    scaffs = sorted(set(p1.covt_scaffolds()) & set(p2.covt_scaffolds()))
    assert scaffs
    cfg = CompareConfig(null_model=ref_null_model,
                        include_self_comparisons=(i == j),
                        store_mismatch_locations=True)
    for scaff in scaffs:
        L = int(s2l[scaff])
        sc = ScaffoldComparison(scaff, L)
        sc.names = ["s1", "s2"]
        sc.profiles = [p1, p2]
        ours, our_mdb, _ = compare_scaffold(sc, null_lut, freq_lut, cfg)

        covTs = [p.get("covT", scaffolds=[scaff])[scaff] for p in (p1, p2)]
        snps = [_snp_for(p, scaff) for p in (p1, p2)]
        (cdb, mdb, _, _), _ = rc.compare_scaffold(
            scaff, ["s1", "s2"], snps, covTs, L, model,
            min_cov=5, min_freq=0.05, store_mismatch_locations=True,
            include_self_comparisons=(i == j))

        m = pd.merge(cdb, ours, on=["mm", "scaffold", "name1", "name2"],
                     how="outer", suffixes=("_g", "_o"), indicator=True)
        assert (m["_merge"] == "both").all()
        for col in ["coverage_overlap", "compared_bases_count",
                    "consensus_SNPs", "population_SNPs", "popANI",
                    "conANI", "percent_genome_compared", "length"]:
            d = (m[col + "_g"] - m[col + "_o"]).abs()
            assert (d.fillna(0) <= 1e-12).all(), (scaff, col)

        # mismatch locations agree as (position, mm) sets
        if mdb is not None and len(mdb):
            gold_set = set(zip(mdb["position"].astype(int),
                               mdb["mm"].astype(int)))
            our_set = set(zip(our_mdb["position"].astype(int),
                              our_mdb["mm"].astype(int)))
            assert gold_set == our_set, scaff

        if i == j:
            # self-comparison invariants (reference test_compare.py:31-131)
            assert (ours["popANI"].dropna() == 1).all()
            assert (ours["consensus_SNPs"] == 0).all()
            assert (ours["coverage_overlap"].dropna() == 1).all()


def test_full_compare_pipeline(tmp_path, ref_null_model):
    from instrain_tpu.compare.pipeline import compare
    cfg = CompareConfig(output=str(tmp_path / "rc"),
                        null_model=ref_null_model,
                        skip_plot_generation=True)
    out = compare(ECOLI[:2], cfg)
    db = out.get("comparisonsTable")
    assert len(db) > 0
    nr = db.sort_values("mm").drop_duplicates(
        subset=["scaffold", "name1", "name2"], keep="last")
    # samples at 100.0 vs 99.9 ANI: popANI should be high but < 1
    assert 0.9 < nr["popANI"].iloc[0] <= 1.0
    assert os.path.exists(out.get_output_base() + "comparisonsTable.tsv")


def test_overlap_counts_device_matches_host():
    """kernels/compare.py: the bf16 einsum over bit-packed masks must
    produce the same integers as the u64-popcount host path (and both
    must equal the naive boolean reduction), including ragged lengths
    that exercise the packing pad and the position-chunk loop."""
    import numpy as np
    from instrain_tpu.kernels import compare as kc
    rng = np.random.default_rng(7)
    old_chunk = kc.CHUNK_BITS
    kc.CHUNK_BITS = 1 << 10  # force multiple chunks
    try:
        for n, mg, L in ((2, 1, 77), (5, 3, 1 << 10), (4, 2, 3000)):
            masks = [rng.random((mg, L)) < rng.random() for _ in range(n)]
            bh, sh = kc.pairwise_overlap_counts_host(masks)
            bd, sd = kc.pairwise_overlap_counts_device(masks)
            np.testing.assert_array_equal(bh, bd)
            np.testing.assert_array_equal(sh, sd)
            for i in range(n):
                assert sh[:, i].tolist() == masks[i].sum(axis=1).tolist()
                for j in range(n):
                    np.testing.assert_array_equal(
                        bh[:, i, j],
                        (masks[i] & masks[j]).sum(axis=1))
    finally:
        kc.CHUNK_BITS = old_chunk
