"""
Compact (device-side compaction) path vs the dense reference path: the two
must produce identical tables.
"""

import numpy as np
import pandas as pd
import pytest

from instrain_tpu.io.fasta import seq_to_codes
from instrain_tpu.profile import compact, tables
from instrain_tpu.profile.linkage import calculate_linkage, window_starts_for
from instrain_tpu.profile.pileup import make_luts, run_site_stats
from instrain_tpu.config import VariantConfig


@pytest.fixture(scope="module")
def both_stats(sars_profiled, ref_null_model):
    pu = sars_profiled["pileup"]
    rc = sars_profiled["ref_codes"]
    luts = make_luts(VariantConfig(null_model=ref_null_model))
    cs = compact.run_site_stats_compact(pu, rc, *luts)
    return sars_profiled["stats"], cs, rc


def test_snp_tables_identical(both_stats):
    st, cs, rc = both_stats
    dense = tables.snp_table(st, rc).reset_index(drop=True)
    comp = compact.snp_table_compact(cs, rc).reset_index(drop=True)
    assert len(dense) == len(comp)
    pd.testing.assert_frame_equal(dense, comp, check_dtype=False)


def test_coverage_tables_identical(both_stats):
    st, cs, rc = both_stats
    dense = tables.coverage_table(st)
    comp = compact.coverage_table_compact(cs)
    assert len(dense) == len(comp)
    for col in dense.columns:
        if col == "scaffold":
            continue
        a = dense[col].values.astype(float)
        b = comp[col].values.astype(float)
        mask = ~(np.isnan(a) & np.isnan(b))
        # clonality means: the dense path averages float32 values with
        # numpy (f32 pairwise), the compact path sums in f64 on device —
        # they agree to f32 resolution
        tol = 1e-6 if col.startswith("nucl_diversity") else 1e-9
        assert np.allclose(a[mask], b[mask], rtol=tol, atol=tol), col


def test_linkage_identical(both_stats):
    st, cs, rc = both_stats
    L = st.pileup.length
    ws = window_starts_for(L, 10000)
    dense = calculate_linkage(st, ws, min_snp=20)
    comp = calculate_linkage(cs, ws, min_snp=20)
    det = [c for c in dense.columns
           if c not in ("r2_normalized", "d_prime_normalized")]
    pd.testing.assert_frame_equal(dense[det], comp[det], check_dtype=False)


def test_transfer_size_is_small(both_stats):
    """The whole compact payload must stay in the low-MB range."""
    _, cs, _ = both_stats
    total = 0
    for group in (cs.rows, cs.agg, cs.linkage, cs.masks):
        for v in group.values():
            total += np.asarray(v).nbytes
    assert total < 12 * 1024 * 1024, total


def test_padded_pileup_matches(both_stats, sars_profiled, ref_null_model):
    """The native padded int16 builder yields the same counts and the same
    compact outputs as the int32 builder + host padding."""
    from instrain_tpu.profile.pileup import (build_scaffold_pileup,
                                             build_scaffold_pileup_padded)
    bam = sars_profiled["bam"]
    pairs = sars_profiled["pairs"]
    pu = sars_profiled["pileup"]
    L = pu.length
    pp = build_scaffold_pileup_padded(bam, pairs, pu.rid, L)
    assert pp.true_M is not None
    assert pp.counts.dtype == np.int16
    assert pp.counts.shape[0] % 8 == 0 and pp.counts.shape[2] % 4096 == 0
    np.testing.assert_array_equal(pp.counts_exact, pu.counts)
    np.testing.assert_array_equal(pp.mm_values, pu.mm_values)
    np.testing.assert_array_equal(pp.qid2mmidx, pu.qid2mmidx)
    # padding rows/cols are all zero
    assert pp.counts.sum() == pu.counts.sum()

    rc = sars_profiled["ref_codes"]
    luts = make_luts(VariantConfig(null_model=ref_null_model))
    cs16 = compact.run_site_stats_compact(pp, rc, *luts)
    _, cs, _ = both_stats
    pd.testing.assert_frame_equal(
        compact.snp_table_compact(cs, rc).reset_index(drop=True),
        compact.snp_table_compact(cs16, rc).reset_index(drop=True),
        check_dtype=False)
    a = compact.coverage_table_compact(cs)
    b = compact.coverage_table_compact(cs16)
    for col in a.columns:
        if col == "scaffold":
            continue
        av = a[col].values.astype(float)
        bv = b[col].values.astype(float)
        mask = ~(np.isnan(av) & np.isnan(bv))
        np.testing.assert_allclose(av[mask], bv[mask], rtol=1e-12, err_msg=col)


def test_batch_engine_matches_dense(tmp_path, ref_null_model):
    """engine='batch' (vmapped bucket kernel + dense ride-along) produces
    the same profile as engine='dense' on a multi-scaffold BAM."""
    import os
    import pandas as pd
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile

    D = "/root/reference/test/test_data/"
    bam = D + "N5_271_010G1_scaffold_failureScaffold.sorted.bam"
    fasta = D + "N5_271_010G1_scaffold_failureScaffold.fa"
    if not os.path.exists(bam):
        import pytest
        pytest.skip("test data missing")

    outs = {}
    for engine in ("dense", "batch"):
        cfg = ProfileConfig(output=str(tmp_path / engine),
                            skip_plot_generation=True,
                            skip_genome_wide=True)
        cfg.engine = engine
        cfg.variant.null_model = ref_null_model
        outs[engine] = profile(bam, fasta, cfg)

    for tbl in ("cumulative_snv_table", "cumulative_scaffold_table",
                "raw_linkage_table"):
        a = outs["dense"].get(tbl).reset_index(drop=True)
        b = outs["batch"].get(tbl).reset_index(drop=True)
        pd.testing.assert_frame_equal(
            a.sort_values(list(a.columns[:3])).reset_index(drop=True),
            b.sort_values(list(b.columns[:3])).reset_index(drop=True),
            check_dtype=False, check_exact=False, rtol=1e-4)

    covA = outs["dense"].get("covT")
    covB = outs["batch"].get("covT")
    assert set(covA) == set(covB)
    for s in covA:
        assert set(covA[s]) == set(covB[s])
        for mm in covA[s]:
            pd.testing.assert_series_equal(covA[s][mm], covB[s][mm])


def test_pack_counts_sparse_roundtrip():
    """Native delta-encoded sparse pack (uint16 index deltas + u8 values
    + saturation corrections; io/bam.py:pack_counts_sparse_d16_into):
    decoding exactly as the device does (idx = cumsum(delta) - 1 +
    scatter-add, kernels/sitestats.py:_densify_sparse) reconstructs the
    tensor bit-exactly — including >65535 gaps chained through
    zero-value entries and self-neutralizing zero padding; over-capacity
    needs are reported back (the caller re-packs before any launch)."""
    from instrain_tpu.io.bam import pack_counts_sparse_d16_into
    rng = np.random.default_rng(0)
    # giant-gap layout: sparse block, >65535-cell gap, dense block
    c = np.zeros((2, 4, 40000), np.int16)
    c[0, 0, 5] = 300
    c[1, 3, 39999] = 7
    dense_part = rng.integers(0, 400, size=(4, 2000), dtype=np.int16)
    dense_part[rng.random(dense_part.shape) < 0.6] = 0
    c[1, :, 1000:3000] = dense_part
    cap = c.size
    d16 = np.zeros(cap, np.uint16)
    vals = np.zeros(cap, np.uint8)
    ci = np.zeros(4096, np.int32)
    cv = np.zeros(4096, np.int32)
    nnz, nc = pack_counts_sparse_d16_into(c, d16, vals, ci, cv)
    assert nnz >= int((c != 0).sum())     # gap-chaining entries add more
    assert nc == int((c > 255).sum())
    idx = np.cumsum(d16.astype(np.int64)) - 1
    rec = np.zeros(c.size, np.int32)
    np.add.at(rec, np.clip(idx, 0, c.size - 1), vals)
    np.add.at(rec, ci[:nc], cv[:nc])
    np.testing.assert_array_equal(rec.reshape(c.shape), c.astype(np.int32))
    # capacity overflow -> reported need exceeds the buffer
    small16 = np.zeros(max(nnz - 1, 1), np.uint16)
    small8 = np.zeros(max(nnz - 1, 1), np.uint8)
    nnz2, _ = pack_counts_sparse_d16_into(c, small16, small8, ci, cv)
    assert nnz2 == nnz and nnz2 > len(small8)


def test_sparse_path_taken_and_matches_two_phase(sars_profiled, ref_null_model):
    """The single-dispatch sparse path is selected for the native padded
    pileup and produces byte-identical outputs to the two-phase path."""
    from instrain_tpu.profile.pileup import build_scaffold_pileup_padded
    import instrain_tpu.profile.compact as C
    bam = sars_profiled["bam"]
    pairs = sars_profiled["pairs"]
    pu0 = sars_profiled["pileup"]
    pp = build_scaffold_pileup_padded(bam, pairs, pu0.rid, pu0.length)
    rc = sars_profiled["ref_codes"]
    luts = make_luts(VariantConfig(null_model=ref_null_model))

    taken = {}
    orig = C._run_compact_sparse

    def spy(*a, **k):
        r = orig(*a, **k)
        taken["sp"] = r is not None
        return r

    C._run_compact_sparse = spy
    try:
        cs_sp = compact.run_site_stats_compact(pp, rc, *luts)
    finally:
        C._run_compact_sparse = orig
    assert taken.get("sp"), "sparse fast path was not taken"

    C._run_compact_sparse = lambda *a, **k: None
    try:
        cs_2p = compact.run_site_stats_compact(pp, rc, *luts)
    finally:
        C._run_compact_sparse = orig

    for grp in ("rows", "agg", "linkage", "masks"):
        a, b = getattr(cs_sp, grp), getattr(cs_2p, grp)
        assert set(a) == set(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if x.shape != y.shape:  # capacities may differ; compare prefix
                n = min(x.shape[-1], y.shape[-1])
                x, y = x[..., :n], y[..., :n]
            if x.dtype.kind == "f":
                np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
                m = ~np.isnan(x)
                np.testing.assert_array_equal(x[m], y[m], err_msg=f"{grp}.{k}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{grp}.{k}")
    pd.testing.assert_frame_equal(
        compact.snp_table_compact(cs_sp, rc).reset_index(drop=True),
        compact.snp_table_compact(cs_2p, rc).reset_index(drop=True),
        check_dtype=False)


def test_batch_sparse_wire_taken(tmp_path, ref_null_model):
    """The batch engine selects the sparse wire
    (site_stats_compact_batch_sparse) for native int16 stacks, and the
    hybrid engine selects the sparse single-dispatch path — neither
    silently falls back."""
    import os
    import instrain_tpu.kernels.sitestats as K
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile

    D = "/root/reference/test/test_data/"
    bam = D + "N5_271_010G1_scaffold_failureScaffold.sorted.bam"
    fasta = D + "N5_271_010G1_scaffold_failureScaffold.fa"
    if not os.path.exists(bam):
        pytest.skip("test data missing")

    calls = []
    orig = K.site_stats_compact_batch_sparse

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return orig(*a, **k)

    K.site_stats_compact_batch_sparse = spy
    try:
        cfg = ProfileConfig(output=str(tmp_path / "b16"),
                            skip_plot_generation=True,
                            skip_genome_wide=True)
        cfg.engine = "batch"
        cfg.variant.null_model = ref_null_model
        profile(bam, fasta, cfg)
    finally:
        K.site_stats_compact_batch_sparse = orig
    assert calls and all(d == np.uint16 for d in calls)


def test_batch_engine_failure_falls_back(tmp_path, ref_null_model):
    """A batch-kernel exception must not kill the run: the pipeline logs a
    FAILURE line and retries every scaffold on the per-scaffold path,
    producing correct tables (reference: per-unit failure containment,
    profile_utilities.py:92-112)."""
    import os
    import instrain_tpu.profile.compact as C
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile

    D = "/root/reference/test/test_data/"
    bam = D + "N5_271_010G1_scaffold_failureScaffold.sorted.bam"
    fasta = D + "N5_271_010G1_scaffold_failureScaffold.fa"
    if not os.path.exists(bam):
        pytest.skip("test data missing")

    def boom(*a, **k):
        raise RuntimeError("injected batch-engine failure")

    # the streaming pipeline routes through run_site_stats_compact_stream
    # (the module attribute, so this injection intercepts it)
    orig = C.run_site_stats_compact_stream
    C.run_site_stats_compact_stream = boom
    try:
        cfg = ProfileConfig(output=str(tmp_path / "fb"),
                            skip_plot_generation=True,
                            skip_genome_wide=True)
        cfg.engine = "batch"
        cfg.variant.null_model = ref_null_model
        out_fb = profile(bam, fasta, cfg)
    finally:
        C.run_site_stats_compact_stream = orig

    log = open(str(tmp_path / "fb" / "log" / "log.log")).read()
    assert "FAILURE EngineException" in log

    cfg = ProfileConfig(output=str(tmp_path / "ok"),
                        skip_plot_generation=True, skip_genome_wide=True)
    cfg.engine = "batch"
    cfg.variant.null_model = ref_null_model
    out_ok = profile(bam, fasta, cfg)
    for tbl in ("cumulative_snv_table", "cumulative_scaffold_table",
                "raw_linkage_table"):
        a = out_ok.get(tbl).reset_index(drop=True)
        b = out_fb.get(tbl).reset_index(drop=True)
        pd.testing.assert_frame_equal(
            a.sort_values(list(a.columns[:3])).reset_index(drop=True),
            b.sort_values(list(b.columns[:3])).reset_index(drop=True),
            check_dtype=False, check_exact=False, rtol=1e-6)


def test_batch_sparse_sharded_matches_unsharded(tmp_path, ref_null_model):
    """The batch engine keeps the sparse wire under a device mesh (scaffold
    axis sharded, corrections per-scaffold) and produces bit-identical
    tables to the unsharded batch run."""
    import os
    import instrain_tpu.kernels.sitestats as K
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile

    D = "/root/reference/test/test_data/"
    bam = D + "N5_271_010G1_scaffold_failureScaffold.sorted.bam"
    fasta = D + "N5_271_010G1_scaffold_failureScaffold.fa"
    if not os.path.exists(bam):
        pytest.skip("test data missing")

    calls = []
    orig = K.site_stats_compact_batch_sparse

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return orig(*a, **k)

    outs = {}
    K.site_stats_compact_batch_sparse = spy
    try:
        for name, n_mesh in (("flat", 0), ("mesh", 8)):
            cfg = ProfileConfig(output=str(tmp_path / name),
                                skip_plot_generation=True,
                                skip_genome_wide=True)
            cfg.engine = "batch"
            cfg.mesh_devices = n_mesh
            cfg.variant.null_model = ref_null_model
            calls.clear()
            outs[name] = profile(bam, fasta, cfg)
            assert calls and all(d == np.uint16 for d in calls), \
                f"sparse wire not taken ({name})"
    finally:
        K.site_stats_compact_batch_sparse = orig

    for tbl in ("cumulative_snv_table", "cumulative_scaffold_table",
                "raw_linkage_table", "raw_snp_table"):
        a = outs["flat"].get(tbl).reset_index(drop=True)
        b = outs["mesh"].get(tbl).reset_index(drop=True)
        pd.testing.assert_frame_equal(a, b, check_dtype=False)
    for special in ("covT", "clonT", "clonTR"):
        ca = outs["flat"].get(special)
        cb = outs["mesh"].get(special)
        assert set(ca) == set(cb)
        for s in ca:
            assert set(ca[s]) == set(cb[s])
            for mm in ca[s]:
                pd.testing.assert_series_equal(ca[s][mm], cb[s][mm])


def test_wire_roundtrip_single_buffer():
    """_pack_out flattens a pytree into ONE uint64 buffer and unpack_wire
    inverts it exactly: <=32-bit leaves bitcast, int64 as-is, and f64
    leaves (clon_sum-shaped sums of f32 clonalities in [0.25, 1]) via the
    lossless scaled-int64 + f32-residual encoding."""
    import jax
    import jax.numpy as jnp
    from instrain_tpu.kernels import sitestats as K

    rng = np.random.default_rng(7)
    # f64 leaf shaped like clon_sum: sums of f32 values in [0.25, 1]
    vals32 = (0.25 + 0.75 * rng.random((16, 1000)).astype(np.float32))
    clon_sum = vals32.astype(np.float64).sum(axis=1)
    tree = {
        "a_bool": rng.random(37) > 0.5,
        "b_i8": rng.integers(-100, 100, 23).astype(np.int8),
        "c_u8": rng.integers(0, 255, 11).astype(np.uint8),
        "d_i16": rng.integers(-30000, 30000, (3, 5)).astype(np.int16),
        "e_i32": rng.integers(-2**31, 2**31 - 1, 9).astype(np.int32),
        "f_f32": rng.random(13).astype(np.float32),
        "g_i64": rng.integers(-2**62, 2**62, 7).astype(np.int64),
        "h_f64": clon_sum,
        "i_f64_edge": np.array([0.0, np.nan, np.inf, -np.inf,
                                -12345.0 / (1 << 26)]),
        "j_scalarish": np.array([5], dtype=np.int64),
    }
    spec_key = ("wire-roundtrip-test",)
    (wire,) = jax.jit(
        lambda t: K._pack_out(t, spec_key))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    wire = np.asarray(wire)
    assert wire.dtype == np.uint64 and wire.ndim == 1
    out = K.unpack_wire(wire, spec_key)
    for name, orig in tree.items():
        got = np.asarray(out[name])
        assert got.shape == orig.shape, name
        if name == "h_f64":
            # lossless for conforming sums
            assert np.array_equal(got, orig), name
        elif name == "i_f64_edge":
            fin = np.isfinite(orig)
            assert np.array_equal(got[fin], orig[fin])  # exact (scaled or
            # residual-representable values)
            assert np.isnan(got[1]) and got[2] == np.inf
            assert got[3] == -np.inf
        else:
            if orig.dtype == np.bool_:
                assert np.array_equal(got.astype(bool), orig), name
            else:
                assert np.array_equal(got, orig), name
            assert got.dtype == orig.dtype, name


def test_fold_keys_matches_device_fold_in():
    """_fold_keys (host-CPU vmapped fold_in; compact.py:127) is
    bit-identical to the per-scaffold jax.random.fold_in it replaced —
    the keys feed the rarefied draws, so parity keeps every engine's
    stochastic columns reproducible."""
    import jax
    base = jax.random.PRNGKey(42)
    rids = [0, 1, 7, 123456, 2 ** 31 - 1]
    keys = compact._fold_keys(42, rids)
    for r, k in zip(rids, keys):
        assert np.array_equal(np.asarray(jax.random.fold_in(base, r)), k)


def test_batch_pipeline_depth_invariant(ref_null_model):
    """The pipelined batch loop (dispatch-ahead, compact.py
    run_site_stats_compact_batch) returns bit-identical stats at any
    pipeline depth / chunking, including multi-chunk runs."""
    from instrain_tpu.profile.pileup import ScaffoldPileup, make_luts
    from instrain_tpu.config import VariantConfig

    rng = np.random.default_rng(3)
    pus, codes = [], []
    for i in range(6):
        L = 1500 + 13 * i
        counts = rng.integers(0, 12, (3, 4, L)).astype(np.int16)
        counts[rng.random(counts.shape) < 0.5] = 0
        counts[0, 0, :: 97] = 300  # exercise saturation corrections
        pus.append(ScaffoldPileup(name=f"p{i}", rid=i, length=L,
                                  mm_values=np.arange(3), counts=counts))
        codes.append(rng.integers(0, 4, L).astype(np.uint8))
    vcfg = VariantConfig()
    vcfg.null_model = ref_null_model
    null_lut, freq_lut = make_luts(vcfg)

    def run(depth, chunk_bytes):
        return compact.run_site_stats_compact_batch(
            pus, codes, null_lut, freq_lut, with_dense=True,
            max_chunk_bytes=chunk_bytes, pipeline_depth=depth)

    run(1, 1 << 30)   # warm the speculative wire capacities
    base = run(1, 1 << 30)   # one chunk, serial
    # 1<<20 makes 4-scaffold chunks: the 6-scaffold run gets a padded
    # tail chunk (compact.py pad_to), also asserted bit-exact
    for depth, cb in ((3, 1 << 16), (2, 1 << 18), (3, 1 << 20),
                      (4, 1 << 30)):
        other = run(depth, cb)  # many chunks, pipelined
        assert len(base) == len(other)
        for a, b in zip(base, other):
            assert (a is None) == (b is None)
            if a is None:
                continue
            for grp in ("rows", "agg", "linkage", "masks"):
                ga, gb = getattr(a, grp), getattr(b, grp)
                for k in ga:
                    va = np.nan_to_num(np.asarray(ga[k]), nan=-7.5)
                    vb = np.nan_to_num(np.asarray(gb[k]), nan=-7.5)
                    assert np.array_equal(va, vb), (grp, k)
            for k in a.dense:
                va = np.nan_to_num(np.asarray(a.dense[k]), nan=-7.5)
                vb = np.nan_to_num(np.asarray(b.dense[k]), nan=-7.5)
                assert np.array_equal(va, vb), ("dense", k)


def test_launch_stall_watchdog(caplog, monkeypatch, ref_null_model):
    """A launch blocked far past the trailing-median launch time emits a
    WARNING with phase attribution, and the run still completes."""
    import logging
    import time as time_mod

    from instrain_tpu.profile.pileup import ScaffoldPileup, make_luts
    from instrain_tpu.config import VariantConfig

    # shrink the watchdog so the faked stall trips within the test
    monkeypatch.setattr(compact, "STALL_CHECK_S", 0.05)
    monkeypatch.setattr(compact, "STALL_FLOOR_S", 0.2)
    monkeypatch.setattr(compact, "STALL_FACTOR", 2.0)

    orig = compact.run_site_stats_compact_batch

    def slow(*a, watch=None, **k):
        if watch is not None:
            # fake a hung device call: a launch phase that never
            # completes within the watchdog limit
            watch.enter("launch")
            time_mod.sleep(0.8)
            watch.launch_done(0.8)
        return orig(*a, watch=watch, **k)

    monkeypatch.setattr(compact, "run_site_stats_compact_batch", slow)

    rng = np.random.default_rng(5)
    pus, codes = [], []
    for i in range(2):
        L = 1200 + i
        counts = rng.integers(0, 10, (2, 4, L)).astype(np.int16)
        counts[rng.random(counts.shape) < 0.5] = 0
        pus.append(ScaffoldPileup(name=f"w{i}", rid=i, length=L,
                                  mm_values=np.arange(2), counts=counts))
        codes.append(rng.integers(0, 4, L).astype(np.uint8))
    vcfg = VariantConfig()
    vcfg.null_model = ref_null_model
    null_lut, freq_lut = make_luts(vcfg)

    # warm the bucket's speculative wire capacities (an overflow on the
    # very first launch returns None by protocol — the pipeline retries
    # those per-scaffold; here we want landed results)
    orig(pus, codes, null_lut, freq_lut, with_dense=True)

    with caplog.at_level(logging.WARNING):
        got = dict(compact.iter_site_stats_compact_batch(
            pus, codes, null_lut, freq_lut, with_dense=True))
    assert len(got) == 2 and all(v is not None for v in got.values())
    stalls = [r for r in caplog.records
              if "launch stall" in r.getMessage()]
    assert stalls, "watchdog did not warn on the faked stall"
    assert "phase 'launch'" in stalls[0].getMessage()


def test_snp_tables_compact_fused_equivalent(both_stats):
    """The fused (snp, csnv) builder (compact.snp_tables_compact — one
    numpy pass, no pandas string maps) equals snp_table_compact +
    tables.cumulative_snv_table column for column, dtype for dtype."""
    _, cs, rc = both_stats
    snp_a = compact.snp_table_compact(cs, rc).reset_index(drop=True)
    csnv_a = tables.cumulative_snv_table(snp_a).reset_index(drop=True)
    snp_b, csnv_b = compact.snp_tables_compact(cs, rc)
    pd.testing.assert_frame_equal(snp_a, snp_b.reset_index(drop=True))
    pd.testing.assert_frame_equal(csnv_a, csnv_b.reset_index(drop=True))


def test_fold_keys_matches_jax_random():
    """The pure-numpy threefry fold_in (compact._fold_keys) must be
    bit-identical to jax.random.fold_in(PRNGKey(seed), rid) — the
    rarefied-draw keys feed the counter-based PRNG, so any drift would
    silently change clonR values everywhere."""
    import numpy as np
    import jax
    from instrain_tpu.profile import compact as C
    for seed in (0, 1, 42, 2**31 - 1, 123456789):
        rids = [0, 1, 2, 7, 63, 1000, 2**31 - 1]
        got = C._fold_keys(seed, rids)
        base = jax.random.PRNGKey(seed)
        want = np.stack([np.asarray(jax.random.fold_in(base, r))
                         for r in rids])
        np.testing.assert_array_equal(got, want.astype(np.uint32)), seed


def test_linkage_cum_overflow_falls_back_to_two_phase(ref_null_model):
    """Cumulative counts above int16 range at a linkage position must
    trip the sparse wire's cum_overflow flag and transparently fall
    back to the two-phase int32 path with correct (un-truncated)
    counts (kernels/sitestats.py:_pack_wire; compact._run_compact_sparse
    returns None on overflow)."""
    import numpy as np
    from instrain_tpu.profile import compact as C
    from instrain_tpu.profile.pileup import ScaffoldPileup, make_luts
    from instrain_tpu.config import VariantConfig

    L = 4096
    counts = np.zeros((2, 4, L), np.int16)
    # consensus-dominated background
    counts[0, 0, :] = 10
    # a true SNV position (morphia 2 -> linkage capture) whose
    # CUMULATIVE A count over both mm levels exceeds 32767 while each
    # exact-mm cell stays within int16
    counts[0, 0, 7] = 16000
    counts[0, 1, 7] = 16000
    counts[1, 0, 7] = 17000
    pu = ScaffoldPileup(name="ovf", rid=1, length=L,
                        mm_values=np.array([0, 2]),
                        counts=counts.astype(np.int16))
    refs = np.zeros(L, np.uint8)
    luts = make_luts(VariantConfig(null_model=ref_null_model))

    calls = {"sparse_none": 0}
    orig = C._run_compact_sparse

    def spy(*a, **k):
        r = orig(*a, **k)
        if r is None:
            calls["sparse_none"] += 1
        return r

    C._run_compact_sparse = spy
    try:
        cs = C.run_site_stats_compact(pu, refs, *luts)
    finally:
        C._run_compact_sparse = orig
    assert calls["sparse_none"] == 1, "sparse path should have bailed"
    # the two-phase result carries the exact int32 cumulative counts
    v = cs.rows["valid"]
    pos = cs.rows["pos"][v]
    assert 7 in pos.tolist()
    i = np.flatnonzero(pos == 7)[-1]
    assert int(cs.rows["total"][v][i]) == 49000
    lk_pos = cs.linkage["pos"][cs.linkage["valid"]]
    j = np.flatnonzero(lk_pos == 7)
    assert len(j) == 1
    assert int(cs.linkage["cum"][:, :, cs.linkage["valid"]][1, 0, j[0]]) \
        == 33000


def test_int16_pileup_overflow_falls_back_to_int32(tmp_path,
                                                   ref_null_model):
    """Exact-mm coverage above 32767 at one cell must make the native
    padded int16 builder bail (build_counts_padded returns None) and the
    int32 builder take over; the engine then routes through the
    two-phase path (the sparse wire requires int16) with exact counts."""
    import numpy as np
    from instrain_tpu.io.bgzf import (bam_header, bam_record, nm_tag,
                                      write_bgzf)
    from instrain_tpu.io.bam import decode_bam
    from instrain_tpu.config import ReadFilterConfig, VariantConfig
    from instrain_tpu.profile.filter_reads import filter_reads
    from instrain_tpu.profile.pileup import (build_scaffold_pileup_padded,
                                             make_luts)
    from instrain_tpu.profile import compact as C

    L = 400
    seq = "A" * 60
    qual = bytes([40]) * 60
    cigar = [(60, "M")]
    n_pairs = 17000  # 34000 reads stacked on pos 0..59 -> cov > 32767
    # |tlen| >= 2*l_qseq hits the legacy overlap_push early-out, so the
    # fully-overlapping mates are BOTH counted (io/bam.py notes)
    parts = [bam_header([("ovf", L)])]
    for q in range(n_pairs):
        parts.append(bam_record(f"r{q}", 99, 0, 0, 42, cigar, 0, 0,
                                200, seq, qual, nm_tag(0)))
        parts.append(bam_record(f"r{q}", 147, 0, 0, 42, cigar, 0, 0,
                                -200, seq, qual, nm_tag(0)))
    bam_path = str(tmp_path / "ovf.bam")
    write_bgzf(bam_path, b"".join(parts))

    bam = decode_bam(bam_path)
    pairs = filter_reads(bam, ReadFilterConfig())
    pu = build_scaffold_pileup_padded(bam, pairs, 0, L)
    assert pu is not None
    assert pu.counts.dtype == np.int32, "int16 fallback did not trigger"
    assert pu.true_M is None
    assert int(pu.counts[:, 0, 30].sum()) == 2 * n_pairs  # both mates


    luts = make_luts(VariantConfig(null_model=ref_null_model))
    cs = C.run_site_stats_compact(pu, np.zeros(L, np.uint8), *luts)
    a = cs.agg
    assert int(a["cov_median"][0]) == 0  # mostly uncovered scaffold
    assert int(a["nonzeros"][0]) == 60


def test_batch_mixed_dtype_bucket_separation(ref_null_model):
    """int16 and int32 pileups sharing a padded (Mp, Lp) shape must run
    in separate chunks (the chunk bucket includes the wire dtype: a
    dense int32 scaffold inside a sparse-sized chunk once blew the
    launch byte bound ~50x) and both produce per-scaffold-exact
    results."""
    import numpy as np
    from instrain_tpu.profile import compact as C
    from instrain_tpu.profile.pileup import ScaffoldPileup, make_luts
    from instrain_tpu.config import VariantConfig

    rng = np.random.default_rng(5)
    L = 2000
    luts = make_luts(VariantConfig(null_model=ref_null_model))
    pileups, refs = [], []
    for i in range(6):
        counts = rng.integers(0, 12, (3, 4, L)).astype(
            np.int16 if i % 2 == 0 else np.int32)
        counts[rng.random(counts.shape) < 0.6] = 0
        pileups.append(ScaffoldPileup(name=f"mx{i}", rid=i, length=L,
                                      mm_values=np.arange(3),
                                      counts=counts))
        refs.append(rng.integers(0, 4, L).astype(np.uint8))
    # same padded bucket shape for all six
    assert len({C._bucket_of(pu)[:2] for pu in pileups}) == 1
    assert len({C._bucket_of(pu) for pu in pileups}) == 2

    batch = C.run_site_stats_compact_batch(pileups, refs, *luts)
    if any(b is None for b in batch):
        # speculative-capacity overflow raised the bucket high-water
        # marks; the second pass succeeds (production retries likewise)
        batch = C.run_site_stats_compact_batch(pileups, refs, *luts)
    assert all(b is not None for b in batch)
    for pu, rc, got in zip(pileups, refs, batch):
        solo = C.run_site_stats_compact(pu, rc, *luts)
        # capacity-independent comparison: the two paths size their
        # compaction buffers differently
        pd.testing.assert_frame_equal(
            C.snp_table_compact(solo, rc).reset_index(drop=True),
            C.snp_table_compact(got, rc).reset_index(drop=True),
            check_dtype=False, obj=pu.name)
        pd.testing.assert_frame_equal(
            C.coverage_table_compact(solo).reset_index(drop=True),
            C.coverage_table_compact(got).reset_index(drop=True),
            check_dtype=False, obj=pu.name)


@pytest.mark.parametrize("seed", [11, 29, 47])
def test_fuzz_dense_vs_compact_random_pileups(seed, ref_null_model):
    """Randomized-input equivalence sweep: arbitrary sparse count
    tensors through the dense reference path and the compact device
    path must produce identical SNP and coverage tables (varied M, L,
    density, and coverage depth per seed)."""
    import numpy as np
    from instrain_tpu.profile import compact as C, tables
    from instrain_tpu.profile.pileup import (ScaffoldPileup, make_luts,
                                             run_site_stats)
    from instrain_tpu.config import VariantConfig

    rng = np.random.default_rng(seed)
    M = int(rng.integers(1, 6))
    L = int(rng.integers(500, 6000))
    depth = int(rng.integers(3, 60))
    counts = rng.integers(0, depth, (M, 4, L)).astype(np.int32)
    counts[rng.random((M, 4, L)) < float(rng.uniform(0.4, 0.9))] = 0
    refs = rng.integers(0, 5, L).astype(np.uint8)  # incl. non-ACTG
    pu = ScaffoldPileup(name=f"fz{seed}", rid=seed, length=L,
                        mm_values=np.arange(M), counts=counts)
    luts = make_luts(VariantConfig(null_model=ref_null_model))

    dense = run_site_stats(pu, refs, *luts)
    comp = C.run_site_stats_compact(pu, refs, *luts)

    pd.testing.assert_frame_equal(
        tables.snp_table(dense, refs).reset_index(drop=True),
        C.snp_table_compact(comp, refs).reset_index(drop=True),
        check_dtype=False)
    a = tables.coverage_table(dense)
    b = C.coverage_table_compact(comp)
    assert len(a) == len(b)
    for col in a.columns:
        if col == "scaffold":
            continue
        va = a[col].values.astype(float)
        vb = b[col].values.astype(float)
        mask = ~(np.isnan(va) & np.isnan(vb))
        tol = 1e-6 if col.startswith("nucl_diversity") else 1e-9
        assert np.allclose(va[mask], vb[mask], rtol=tol, atol=tol), \
            (col, seed)


def test_batch_engine_skip_mm_matches_dense(tmp_path, ref_null_model):
    """--skip_mm_profiling through the batch engine (collapsed int32
    pileups ride the dense-chunk path) must match the dense engine."""
    import os
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.pipeline import profile

    D = "/root/reference/test/test_data/"
    bam = D + "N5_271_010G1_scaffold_failureScaffold.sorted.bam"
    fasta = D + "N5_271_010G1_scaffold_failureScaffold.fa"
    if not os.path.exists(bam):
        pytest.skip("test data missing")

    outs = {}
    for engine in ("dense", "batch"):
        cfg = ProfileConfig(output=str(tmp_path / f"sm_{engine}"),
                            skip_plot_generation=True,
                            skip_genome_wide=True,
                            skip_mm_profiling=True)
        cfg.engine = engine
        cfg.variant.null_model = ref_null_model
        outs[engine] = profile(bam, fasta, cfg)

    for tbl in ("cumulative_snv_table", "cumulative_scaffold_table"):
        a = outs["dense"].get(tbl).reset_index(drop=True)
        b = outs["batch"].get(tbl).reset_index(drop=True)
        assert len(a) == len(b) and len(a) > 0, tbl
        pd.testing.assert_frame_equal(
            a.sort_values(list(a.columns[:3])).reset_index(drop=True),
            b.sort_values(list(b.columns[:3])).reset_index(drop=True),
            check_dtype=False, check_exact=False, rtol=1e-4)
    # the collapsed tables carry a single mm level
    assert set(outs["batch"].get("cumulative_scaffold_table")["mm"]) \
        == {0}
