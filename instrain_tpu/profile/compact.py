"""
Compact profiling path: table builders over the on-device-compacted
site-stats outputs (kernels.sitestats.site_stats_compact).

Produces the same raw SNP / cumulative SNV / scaffold tables as
profile/tables.py, but from KB-scale device transfers — the dense
per-position arrays never leave the device. Used for accelerator
execution, where device->host copies are costly; the dense path remains
the reference implementation (they are cross-checked in tests).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..kernels.sitestats import (CLASS_NAMES, compact_outputs,
                                 compact_outputs_with_dense, compact_sizes,
                                 site_stats, site_stats_compact)
from .pileup import ScaffoldPileup, _bucket
from .tables import BASES, cumulative_snv_table, estimate_breadth

SNP_CAPACITY = 32768
POS_CAPACITY = 16384

# Benchmark instrumentation: set to a dict ({} works) to accumulate
# per-phase wall seconds of the device paths (pack / h2d / compute /
# fetch). None (production) adds no synchronization.
TIMINGS: Optional[Dict[str, float]] = None


def _t_add(key: str, dt: float):
    if TIMINGS is not None:
        TIMINGS[key] = TIMINGS.get(key, 0.0) + dt
        TIMINGS["launches"] = TIMINGS.get("launches", 0) + (
            1 if key == "compute" else 0)


# Launch stall watchdog tuning (tests shrink these to fake a stall):
# the monitor polls every STALL_CHECK_S and warns when a launch phase has
# been blocked longer than max(STALL_FACTOR x trailing-median launch,
# STALL_FLOOR_S). Purely observational — it never interrupts a device
# call; unfinished scaffolds already retry per-scaffold when the engine
# errors (pipeline._profile_scaffolds_batched).
STALL_CHECK_S = 5.0
STALL_FLOOR_S = 60.0
STALL_FACTOR = 10.0


class LaunchWatch:
    """Thread-shared telemetry of the batch device loop: which launch
    phase (pack / launch / fetch) is currently blocking and for how
    long, plus completed launch round-trip times for the trailing
    median, so that a launch that hangs is reported instead of leaving a
    run silent."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.phase = "idle"
        self.since = time.perf_counter()
        self.launch_s: list = []

    def enter(self, phase: str):
        with self._lock:
            self.phase = phase
            self.since = time.perf_counter()

    def launch_done(self, dt: float):
        with self._lock:
            self.launch_s.append(dt)
            self.phase = "idle"
            self.since = time.perf_counter()

    def snapshot(self):
        with self._lock:
            return (self.phase, time.perf_counter() - self.since,
                    list(self.launch_s))


class CompactStats:
    """Host view of site_stats_compact outputs for one scaffold."""

    def __init__(self, pileup: ScaffoldPileup, out: Dict, M: int, L: int):
        self.pileup = pileup
        self.M = M
        self.L = L
        self.rows = {k: np.asarray(v) for k, v in out["rows"].items()}
        self.agg = {k: np.asarray(v)[:M] for k, v in out["agg"].items()}
        self.linkage = {k: np.asarray(v) for k, v in out["linkage"].items()}
        self.masks = {k: np.asarray(v) for k, v in out["masks"].items()}
        if int(self.rows["n_rows"]) > len(self.rows["pos"]):
            raise RuntimeError(
                f"SNP row capacity exceeded: {int(self.rows['n_rows'])}")
        if int(self.linkage["n_pos"]) > len(self.linkage["pos"]):
            raise RuntimeError(
                f"SNV position capacity exceeded: "
                f"{int(self.linkage['n_pos'])}")

    @property
    def mm_values(self):
        return self.pileup.mm_values

    @property
    def any_snp(self):
        return self.masks["any_snp"][:self.L]

    @property
    def bases_mask(self):
        return self.masks["bases_mask"][:, :self.L]

    @property
    def cryptic(self):
        return self.masks["cryptic"][:self.L]


def _pow2_capacity(n: int, lo: int = 1024, hi: int = 1 << 22) -> int:
    cap = lo
    while cap < n and cap < hi:
        cap <<= 1
    return cap


def _padded_inputs(pileup: ScaffoldPileup, ref_codes: np.ndarray):
    """Bucket-padded (counts, ref_codes) plus true (M, L). Pileups from the
    native padded builder (true_M set) pass through with no host copy."""
    counts = pileup.counts
    if pileup.true_M is not None:
        M, L = pileup.true_M, pileup.length
        Lp = counts.shape[2]
        if Lp != len(ref_codes):
            rp = np.full(Lp, 4, dtype=ref_codes.dtype)
            rp[:L] = ref_codes
            ref_codes = rp
        return counts, np.ascontiguousarray(ref_codes), M, L
    M, _, L = counts.shape
    Mp, Lp = max(_bucket(M, 8), 8), max(_bucket(L, 4096), 4096)
    if (Mp, Lp) != (M, L):
        cp = np.zeros((Mp, 4, Lp), counts.dtype)
        cp[:M, :, :L] = counts
        rp = np.full(Lp, 4, dtype=ref_codes.dtype)
        rp[:L] = ref_codes
        counts, ref_codes = cp, rp
    return counts, np.ascontiguousarray(ref_codes), M, L


# Speculative capacities for the single-dispatch sparse paths: per-bucket
# (padded shape) high-water marks (pow2). An output-capacity overflow
# costs one extra kernel run+compile, then every later launch of that
# bucket reuses the raised capacity; input (vals/corr) overflow is known
# at pack time and only costs a re-pack. Low floor: capacity padding is
# pure copy waste (SNV counts per scaffold are typically O(100)).
_SPEC_CAPS: Dict = {}


def _bucket_caps(shape) -> Dict:
    # "vals" starts at Lp: measured nonzero-cell density is ~5-10% of
    # Mp*4*Lp, i.e. a fraction-to-few multiples of Lp per scaffold
    return _SPEC_CAPS.setdefault(tuple(shape),
                                 {"snp": 256, "pos": 256, "rpos": 256,
                                  "corr": 64,
                                  "vals": max(4096, int(shape[-1]))})


def _np_threefry2x32(k0, k1, x0, x1):
    """Pure-numpy Threefry-2x32 (20 rounds), vectorized over uint32
    arrays — the same permutation as kernels.sitestats._threefry2x32
    and JAX's default PRNG (bit-identity asserted in tests)."""
    u = np.uint32
    k0, k1 = u(k0), u(k1)
    x0 = np.asarray(x0, dtype=np.uint32).copy()
    x1 = np.asarray(x1, dtype=np.uint32).copy()
    ks2 = u(np.uint32(0x1BD11BDA) ^ k0 ^ k1)

    def four(x0, x1, rots):
        for r in rots:
            x0 = u(x0 + x1) if np.isscalar(x0) else (x0 + x1)
            x1 = (x1 << u(r)) | (x1 >> u(32 - r))
            x1 = x1 ^ x0
        return x0, x1

    ra = (13, 15, 26, 6)
    rb = (17, 29, 16, 24)
    x0 = x0 + k0
    x1 = x1 + k1
    x0, x1 = four(x0, x1, ra)
    x0 = x0 + k1
    x1 = x1 + ks2 + u(1)
    x0, x1 = four(x0, x1, rb)
    x0 = x0 + ks2
    x1 = x1 + k0 + u(2)
    x0, x1 = four(x0, x1, ra)
    x0 = x0 + k0
    x1 = x1 + k1 + u(3)
    x0, x1 = four(x0, x1, rb)
    x0 = x0 + k1
    x1 = x1 + ks2 + u(4)
    x0, x1 = four(x0, x1, ra)
    x0 = x0 + ks2
    x1 = x1 + k0 + u(5)
    return x0, x1


def _fold_keys(seed: int, rids) -> np.ndarray:
    """PRNG keys fold_in(PRNGKey(seed), rid) for many rids, computed in
    PURE NUMPY: JAX's threefry PRNGKey(seed) is the raw
    [seed >> 32, seed & 0xffffffff] pair and fold_in(key, d) is one
    Threefry-2x32 application to [d >> 32, d & 0xffffffff] — both
    replicated here bit-identically (asserted against jax.random in
    tests). The former vmapped CPU-backend call paid a fresh XLA
    compile per distinct rid-count (~0.8 s per batch chunk shape)."""
    rids = np.asarray(list(rids), dtype=np.uint64)
    s = np.uint64(np.int64(seed).astype(np.uint64))
    k0 = np.uint32(s >> np.uint64(32))
    k1 = np.uint32(s & np.uint64(0xFFFFFFFF))
    x0 = (rids >> np.uint64(32)).astype(np.uint32)
    x1 = (rids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    o0, o1 = _np_threefry2x32(k0, k1, x0, x1)
    return np.stack([o0, o1], axis=1).astype(np.uint32)


def _unpack_wire_masks(masks: Dict, Lp: int) -> Dict:
    """Host-side unpack of the wire's bit-packed position masks — the
    single inverse of kernels.sitestats._pack_wire, shared by the
    single-scaffold and batch consumers so a wire-format change cannot
    silently diverge between them."""
    return dict(
        cryptic=np.unpackbits(masks["cryptic"])[:Lp].astype(bool),
        any_snp=np.unpackbits(masks["any_snp"])[:Lp].astype(bool),
        bases_mask=np.unpackbits(masks["bases_mask"],
                                 axis=-1)[:, :Lp].astype(bool))


def _clonR_from_sparse(sp: Dict, k, M: int, L: int) -> np.ndarray:
    """Reconstruct the dense [M, L] rarefied-clonality array from the
    wire's sparse (pos, vals) slice — NaN everywhere no mm level reached
    rarefied coverage (exactly how the device kernel leaves those cells).
    `k=None` selects the unbatched (single-scaffold) layout."""
    pos = sp["pos"] if k is None else sp["pos"][k]
    vals = sp["vals"] if k is None else sp["vals"][k]
    n = int(sp["n"] if k is None else sp["n"][k])
    if n == 0:
        return np.broadcast_to(np.float32(np.nan), (M, L))
    out = np.full((M, L), np.nan, dtype=np.float32)
    v = pos >= 0
    out[:, pos[v]] = vals[:, v]
    return out


def _pack_sparse(counts: np.ndarray, caps: Dict):
    """Sparse-pack one int16 count tensor (delta-encoded d16 wire) with
    the bucket's speculative vals/corr capacities, re-packing with
    raised (pow2 high-water) capacities on overflow — known at pack
    time, before any kernel launch, so no kernel run is ever wasted.
    Returns None when the need exceeds the capacity ceiling (the wire
    would beat the dense tensor at that density anyway) — the caller
    falls back to the two-phase path."""
    from ..io.bam import pack_counts_sparse_d16_into
    hi = 1 << 28
    while True:
        V, C = caps["vals"], caps["corr"]
        d16 = np.zeros(V, np.uint16)
        vals = np.zeros(V, np.uint8)
        ci = np.zeros(C, np.int32)
        cv = np.zeros(C, np.int32)
        nnz, nc = pack_counts_sparse_d16_into(counts, d16, vals, ci, cv)
        if nnz <= V and nc <= C:
            return d16, vals, ci, cv
        before = (V, C)
        if nnz > V:
            caps["vals"] = max(V, _pow2_capacity(nnz, lo=4096, hi=hi))
        if nc > C:
            caps["corr"] = max(C, _pow2_capacity(nc, lo=64, hi=hi))
        if (caps["vals"], caps["corr"]) == before:
            return None  # capacity ceiling: re-packing cannot help


def _run_compact_sparse(counts: np.ndarray, ref_codes: np.ndarray, L: int,
                    null_lut: np.ndarray, freq_lut: np.ndarray, key,
                    min_cov: int, rarefied_coverage: int,
                    with_dense: bool = False) -> Optional[Dict]:
    """Single-dispatch sparse compact run (see site_stats_compact_sparse).
    Returns the host output dict with masks unpacked and linkage counts
    widened, or None when this path doesn't apply (non-int16 counts,
    linkage-count overflow) — the caller falls back to two-phase.
    With with_dense, out["dense"] holds clon/clonR; the caller adds the
    host-reconstructed total."""
    from ..kernels.sitestats import site_stats_compact_sparse
    if counts.dtype != np.int16:
        return None
    caps = _bucket_caps(counts.shape)
    t0 = time.perf_counter()
    packed = _pack_sparse(counts, caps)
    _t_add("pack", time.perf_counter() - t0)
    if packed is None:
        return None
    d16, vals, cidx, cval = packed
    from ..kernels.sitestats import unpack_wire
    if TIMINGS is not None:
        # explicit, synchronized h2d so the benchmark can separate the
        # transfer from the compute (production lets dispatch overlap it)
        t0 = time.perf_counter()
        _t_add("h2d_bytes", float(sum(
            np.asarray(x).nbytes
            for x in (d16, vals, cidx, cval, ref_codes))))
        d16, vals, cidx, cval, ref_codes, null_lut, freq_lut = [
            jax.block_until_ready(jax.device_put(x))
            for x in (d16, vals, cidx, cval, ref_codes, null_lut,
                      freq_lut)]
        _t_add("h2d", time.perf_counter() - t0)
    for _ in range(8):
        skey = ("sp", counts.shape, len(vals), cidx.shape[0],
                caps["snp"], caps["pos"], caps["rpos"],
                with_dense, min_cov, rarefied_coverage)
        t0 = time.perf_counter()
        res = site_stats_compact_sparse(
            d16, vals, cidx, cval, ref_codes, null_lut, freq_lut, key,
            np.int32(L), shape=counts.shape, min_cov=min_cov,
            min_covR=rarefied_coverage,
            rarefied_draws=rarefied_coverage,
            snp_capacity=caps["snp"],
            pos_capacity=caps["pos"], rpos_capacity=caps["rpos"],
            with_dense=with_dense, spec_key=skey)
        if TIMINGS is not None:
            jax.block_until_ready(res)
        _t_add("compute", time.perf_counter() - t0)
        # ONE packed fetch for everything — with_dense, the rarefied
        # clonality crosses SPARSELY inside the same wire (values only
        # at positions where some mm level reached rarefied coverage)
        t0 = time.perf_counter()
        wire = np.asarray(res[0])
        _t_add("fetch", time.perf_counter() - t0)
        _t_add("fetch_bytes", float(wire.nbytes))
        out = unpack_wire(wire, skey)
        if bool(out["linkage"].pop("cum_overflow")):
            return None
        n_rows = int(out["rows"]["n_rows"])
        n_pos = int(out["linkage"]["n_pos"])
        sp = out.pop("clonR_sparse", None)
        # the kernel's rarefied draws run at gathered positions only;
        # n_rar > rpos capacity means clonR aggregates are incomplete in
        # EVERY mode, not just when the sparse clonR rides the wire
        n_rar = int(out["linkage"].pop("n_rar", 0))
        if (n_rows <= caps["snp"] and n_pos <= caps["pos"] and
                n_rar <= caps["rpos"]):
            Lp = counts.shape[-1]
            out["masks"] = _unpack_wire_masks(out["masks"], Lp)
            out["linkage"]["cum"] = out["linkage"]["cum"].astype(np.int32)
            if sp is not None:
                out["dense"] = dict(clonR=_clonR_from_sparse(
                    sp, None, counts.shape[0], Lp))
            return out
        before = (caps["snp"], caps["pos"], caps["rpos"])
        caps["snp"] = max(caps["snp"], _pow2_capacity(n_rows, lo=256))
        caps["pos"] = max(caps["pos"], _pow2_capacity(n_pos, lo=256))
        caps["rpos"] = max(caps["rpos"], _pow2_capacity(n_rar, lo=256))
        if (caps["snp"], caps["pos"], caps["rpos"]) == before:
            return None  # capacity ceiling: retrying cannot help
    return None


def _run_compact_sparse_contained(*args, **kwargs) -> Optional[Dict]:
    """_run_compact_sparse with failure containment: an exception in the
    sparse fast path logs a FAILURE line and falls through to the two-phase path
    (None) instead of killing the scaffold — the reference never dies on
    one bad unit (profile_utilities.py:92-112)."""
    try:
        return _run_compact_sparse(*args, **kwargs)
    except Exception as e:
        import logging

        from ..obs.logging import log_failure
        log_failure("EngineException", "sparse_wire", str(e))
        logging.error(f"sparse wire path failed ({e}); falling back to "
                      f"two-phase path")
        return None


def _run_two_phase(counts, ref_codes, L, null_lut, freq_lut, key,
                   min_cov, rarefied_coverage, with_dense: bool,
                   mesh=None):
    """Two-phase compact run: (1) the fused kernel leaves its dense
    outputs on device and only two scalars (row/position counts) come
    back; (2) the compaction gather runs with right-sized power-of-two
    capacities. With `mesh`, inputs are placed position-sharded across
    the device mesh and XLA SPMD-partitions both phases
    (parallel/mesh.py)."""
    if mesh is not None:
        from ..parallel.mesh import place_position_sharded
        counts, ref_codes = place_position_sharded(
            np.asarray(counts), np.asarray(ref_codes), mesh)
    else:
        # one host->device transfer of the count tensor; both kernel
        # calls reuse the device-resident buffer
        counts = jax.device_put(counts)
    full = site_stats(counts, ref_codes, null_lut,
                      freq_lut, key, min_cov=min_cov,
                      min_covR=rarefied_coverage,
                      rarefied_draws=rarefied_coverage)
    n_rows, n_pos = jax.device_get(compact_sizes(full))
    fn = compact_outputs_with_dense if with_dense else compact_outputs
    out = fn(full, counts, L,
             snp_capacity=_pow2_capacity(int(n_rows)),
             pos_capacity=_pow2_capacity(int(n_pos)))
    return jax.device_get(out)


def run_site_stats_compact(pileup: ScaffoldPileup, ref_codes: np.ndarray,
                           null_lut: np.ndarray, freq_lut: np.ndarray,
                           min_cov: int = 5, rarefied_coverage: int = 50,
                           seed: int = 42, mesh=None) -> CompactStats:
    """
    Single-dispatch sparse run when the counts fit (the common case), else a
    two-phase compact run. Total device->host traffic is proportional to
    the actual number of SNVs. With `mesh`, the two-phase path runs
    position-sharded over the device mesh.
    """
    counts, ref_codes, M, L = _padded_inputs(pileup, ref_codes)
    key = _fold_keys(seed, [pileup.rid])[0]
    if mesh is None:
        out_sp = _run_compact_sparse_contained(
            counts, ref_codes, L, null_lut, freq_lut, key, min_cov,
            rarefied_coverage)
        if out_sp is not None:
            return CompactStats(pileup, out_sp, M, L)
    out = _run_two_phase(counts, ref_codes, L, null_lut, freq_lut, key,
                         min_cov, rarefied_coverage, with_dense=False,
                         mesh=mesh)
    return CompactStats(pileup, out, M, L)


class HybridStats(CompactStats):
    """CompactStats plus the dense arrays needed for storage and gene
    profiling (total / clon / clonR), exposed with the ScaffoldStats
    attribute names so tables.covT/clonT views and profile/genes work
    unchanged.

    `dense` may be provided LAZILY (set `_dense_fn` to a thunk): the
    batch engine's finish step runs on the device-loop thread, where
    host-side clon/total reconstruction (~native pass over the count
    tensor per scaffold) would serialize with the next launch; deferring
    it to first access moves that work to the consumer thread, which
    overlaps device launches (blocked device calls release the GIL)."""

    _dense = None
    _dense_fn = None

    @property
    def dense(self):
        if self._dense is None and self._dense_fn is not None:
            self._dense = self._dense_fn()
            self._dense_fn = None
        return self._dense

    @dense.setter
    def dense(self, value):
        self._dense = value

    @property
    def total(self):
        return self.dense["total"][:self.M, :self.L]

    @property
    def clon(self):
        return self.dense["clon"][:self.M, :self.L]

    @property
    def clonR(self):
        return self.dense["clonR"][:self.M, :self.L]


def run_site_stats_hybrid(pileup: ScaffoldPileup, ref_codes: np.ndarray,
                          null_lut: np.ndarray, freq_lut: np.ndarray,
                          min_cov: int = 5, rarefied_coverage: int = 50,
                          seed: int = 42, mesh=None) -> HybridStats:
    """Hybrid run: compact outputs plus the storage-needed dense arrays.
    sparse single-dispatch when the counts fit (clon/clonR fetched, total
    reconstructed natively on host from the counts we already hold), else
    the two-phase path (~9 MB/scaffold instead of ~40 MB for the full
    dict). With `mesh`, the two-phase path runs position-sharded over the
    device mesh (parallel/mesh.py)."""
    counts, ref_codes, M, L = _padded_inputs(pileup, ref_codes)
    key = _fold_keys(seed, [pileup.rid])[0]
    if mesh is None:
        out_sp = _run_compact_sparse_contained(
            counts, ref_codes, L, null_lut, freq_lut, key, min_cov,
            rarefied_coverage, with_dense=True)
        if out_sp is not None:
            from ..io.bam import clon_cum16
            dense = out_sp.pop("dense")
            cs = HybridStats(pileup, out_sp, M, L)
            total, clon = clon_cum16(counts, M, min_cov)
            cs.dense = {"total": total, "clon": clon,
                        "clonR": np.asarray(dense["clonR"])}
            return cs
    out = _run_two_phase(counts, ref_codes, L, null_lut, freq_lut, key,
                         min_cov, rarefied_coverage, with_dense=True,
                         mesh=mesh)
    dense = out.pop("dense")
    cs = HybridStats(pileup, out, M, L)
    if counts.dtype == np.int16:
        # total/clon from the same host pass as the sparse path: the
        # device's f32 clonality can differ from it in the last bit, and
        # the position-sharded (mesh) run must equal the 1-device run
        from ..io.bam import clon_cum16
        total, clon = clon_cum16(counts, M, min_cov)
        cs.dense = {"total": total, "clon": clon,
                    "clonR": np.asarray(dense["clonR"])}
    else:
        cs.dense = {k: np.asarray(v) for k, v in dense.items()}
    return cs


def _snp_columns_compact(cs: CompactStats, ref_codes: np.ndarray):
    """Numpy column dict of the raw SNP table plus the integer base
    codes needed for the freq columns (None when the scaffold has no
    rows)."""
    r = cs.rows
    v = r["valid"] & (r["mm_idx"] < cs.M) & (r["pos"] < cs.L)
    if not v.any():
        return None
    pos = r["pos"][v]
    mmi = r["mm_idx"][v]
    A = r["A"][v].astype(np.int64)
    C = r["C"][v].astype(np.int64)
    T = r["T"][v].astype(np.int64)
    G = r["G"][v].astype(np.int64)
    con_i = r["con"][v].astype(np.int64)
    var_i = r["var"][v].astype(np.int64)
    ref_i = np.minimum(ref_codes[pos], 4).astype(np.int64)
    table = {
        "scaffold": cs.pileup.name,
        "position": pos.astype(np.int64),
        "ref_base": BASES[ref_i],
        "A": A, "C": C, "T": T, "G": G,
        "con_base": BASES[con_i],
        "var_base": BASES[var_i],
        "mm": cs.mm_values[mmi].astype(np.int64),
        "allele_count": r["morphia"][v].astype(np.int64),
        "class": np.array(CLASS_NAMES)[r["cls"][v]],
        "cryptic": r["cryptic"][v].astype(bool),
        "position_coverage": r["total"][v].astype(np.int64),
    }
    codes = dict(counts4=np.stack([A, C, T, G], axis=1),
                 con_i=con_i, var_i=var_i, ref_i=ref_i)
    return table, codes


def snp_table_compact(cs: CompactStats, ref_codes: np.ndarray
                      ) -> pd.DataFrame:
    cols = _snp_columns_compact(cs, ref_codes)
    if cols is None:
        return pd.DataFrame()
    return pd.DataFrame(cols[0])


def snp_tables_compact(cs: CompactStats, ref_codes: np.ndarray):
    """(raw_snp_table, cumulative_snv_table) built in ONE numpy pass.

    Equivalent to snp_table_compact + tables.cumulative_snv_table
    (asserted by tests), but the var/con/ref freq columns come straight
    from the integer base codes — the pandas route (string .map over
    object columns + per-column __getitem__/copy) measured ~60 ms per
    scaffold and dominated the batch engine's host-side table time at
    metagenome scale (reference freq semantics:
    profile_utilities.py:598-612 _parse_Sdb)."""
    cols = _snp_columns_compact(cs, ref_codes)
    if cols is None:
        return pd.DataFrame(), pd.DataFrame()
    table, codes = cols
    counts4 = codes["counts4"]
    n = len(counts4)
    rows = np.arange(n)
    pc = table["position_coverage"].astype(np.float64)
    var_freq = counts4[rows, codes["var_i"]] / pc
    con_freq = counts4[rows, codes["con_i"]] / pc
    ref_freq = np.full(n, np.nan)
    ok = codes["ref_i"] < 4
    ref_freq[ok] = counts4[rows[ok], codes["ref_i"][ok]] / pc[ok]
    snp = pd.DataFrame(table)
    csnv = pd.DataFrame({**table, "var_freq": var_freq,
                         "con_freq": con_freq, "ref_freq": ref_freq})
    return snp, csnv


def coverage_table_compact(cs: CompactStats) -> pd.DataFrame:
    """make_coverage_table from per-mm device aggregates."""
    a = cs.agg
    L = cs.L
    M = cs.M
    active = a["mm_active"].astype(bool)
    out: Dict[str, np.ndarray] = {}
    out["scaffold"] = np.array([cs.pileup.name] * M)
    out["length"] = np.full(M, L)
    out["breadth"] = a["nonzeros"] / L
    mean = a["cov_sum"] / L
    out["coverage"] = mean
    out["coverage_median"] = a["cov_median"].astype(int)
    var0 = a["cov_sumsq"] / L - mean * mean
    out["coverage_std"] = np.sqrt(np.maximum(var0, 0))
    var1 = (a["cov_sumsq"] - L * mean * mean) / (L - 1) if L > 1 else np.nan
    with np.errstate(invalid="ignore"):
        out["coverage_SEM"] = np.sqrt(np.maximum(var1, 0)) / np.sqrt(L)

    counted = a["counted"]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_c = np.where(counted > 0, a["clon_sum"] / np.maximum(counted, 1),
                          np.nan)
    out["nucl_diversity"] = 1 - mean_c
    out["nucl_diversity_median"] = np.where(counted > 0,
                                            1 - a["clon_median"], np.nan)
    rarefied = a["rarefied"]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_r = np.where(rarefied > 0,
                          a["clonR_sum"] / np.maximum(rarefied, 1), np.nan)
    out["nucl_diversity_rarefied"] = 1 - mean_r
    out["nucl_diversity_rarefied_median"] = np.where(
        rarefied > 0, 1 - a["clonR_median"], np.nan)
    out["breadth_minCov"] = counted / L
    out["breadth_rarefied"] = rarefied / L
    out["breadth_expected"] = estimate_breadth(out["coverage"])
    out["divergent_site_count"] = a["div_sites"]
    out["SNS_count"] = a["sns"]
    out["SNV_count"] = a["snv"]
    out["consensus_divergent_sites"] = a["con_snps"]
    out["population_divergent_sites"] = a["pop_snps"]
    with np.errstate(invalid="ignore", divide="ignore"):
        out["conANI_reference"] = np.where(
            counted > 0, (counted - a["con_snps"]) / np.maximum(counted, 1),
            0)
        out["popANI_reference"] = np.where(
            counted > 0, (counted - a["pop_snps"]) / np.maximum(counted, 1),
            0)
    out["mm"] = cs.mm_values.astype(np.int64)
    df = pd.DataFrame(out)
    return df[active].reset_index(drop=True)


def _pack_sparse_chunk(part, Mp: int, Lp: int, caps: Dict, Sp0: int):
    """Sparse-pack each scaffold's already-padded int16 counts straight
    into the chunk's wire stacks (native per-scaffold pass — no int16
    stacking copy): [S, V] uint16 index deltas + [S, V] u8 values +
    [S, C] correction rows (within-scaffold flat indices, so densify
    stays shard-local under a mesh). V/C are the bucket's speculative
    high-water marks, raised and re-packed on overflow — known before
    launch, so no kernel run is wasted.
    np.zeros = calloc: tail-padding scaffolds stay untouched virtual zero
    pages (an explicit memset cost ~2 s on this bandwidth-throttled
    host); packed rows overwrite their own pages; all-zero pad rows
    decode to a harmless scatter-add of 0."""
    from ..io.bam import pack_counts_sparse_d16_into

    def padded16(pu):
        # native padded-builder pileups pass through zero-copy; ragged
        # int16 pileups (tests/synthetic) get a per-scaffold padded temp
        if pu.true_M is not None and pu.counts.shape == (Mp, 4, Lp):
            return pu.counts
        ce = pu.counts_exact
        M, _, L = ce.shape
        tmp = np.zeros((Mp, 4, Lp), np.int16)
        tmp[:M, :, :L] = ce
        return tmp

    hi = 1 << 28
    while True:
        V, C = caps["vals"], caps["corr"]
        d16 = np.zeros((Sp0, V), np.uint16)
        vals = np.zeros((Sp0, V), np.uint8)
        ci = np.zeros((Sp0, C), np.int32)
        cv = np.zeros((Sp0, C), np.int32)
        need_v = need_c = 0
        for k, (_i, pu, _rc) in enumerate(part):
            nnz, nc = pack_counts_sparse_d16_into(padded16(pu), d16[k],
                                                  vals[k], ci[k], cv[k])
            need_v = max(need_v, nnz)
            need_c = max(need_c, nc)
        if need_v <= V and need_c <= C:
            return d16, vals, ci, cv
        before = (V, C)
        if need_v > V:
            caps["vals"] = max(V, _pow2_capacity(need_v, lo=4096, hi=hi))
        if need_c > C:
            caps["corr"] = max(C, _pow2_capacity(need_c, lo=64, hi=hi))
        if (caps["vals"], caps["corr"]) == before:
            # capacity ceiling: contained by the engine-exception path,
            # whose per-scaffold retry right-sizes or goes dense
            raise RuntimeError(
                f"sparse wire capacity ceiling (need {need_v}/{need_c})")


def _dispatch_batch_chunk(part, Mp, Lp, use_sparse, null_lut, freq_lut,
                          min_cov, rarefied_coverage, seed, with_dense,
                          mesh, pad_to=None, watch=None):
    """Build one chunk's inputs and dispatch its kernel WITHOUT waiting
    for the result (jax dispatch is asynchronous, so the next chunk's
    host packing and h2d overlap this chunk's device compute). Returns a
    pending record for _finish_batch_chunk.

    `pad_to` pads the scaffold axis with zero-count/length-0 dummies so a
    bucket's tail chunk reuses the full chunk's compiled kernel shape
    (one XLA compile per bucket, not one per distinct tail size); the
    same masking convention as the mesh padding (parallel/mesh.py:87)."""
    S = len(part)
    Sp0 = max(pad_to or S, S)
    refs = np.full((Sp0, Lp), 4, np.uint8)
    lens = np.zeros(Sp0, np.int64)
    for k, (_i, pu, rc) in enumerate(part):
        refs[k, :pu.length] = rc
        lens[k] = pu.length
    keys_arr = _fold_keys(seed, [pu.rid for _i, pu, _rc in part] +
                          [0] * (Sp0 - S))
    rec = dict(part=part, Mp=Mp, Lp=Lp)
    if use_sparse:
        from ..kernels.sitestats import site_stats_compact_batch_sparse
        caps = _bucket_caps((Mp, 4, Lp))
        if watch is not None:
            watch.enter("pack")
        t0 = time.perf_counter()
        d16, vals, cidx_s, cval_s = _pack_sparse_chunk(part, Mp, Lp,
                                                       caps, Sp0)
        _t_add("pack", time.perf_counter() - t0)
        if mesh is not None:
            from ..parallel.mesh import place_batch_sharded
            placed = place_batch_sharded(
                dict(d16=d16, vals=vals, cidx=cidx_s, cval=cval_s,
                     ref_codes=refs, lens=lens, keys=keys_arr), mesh)
            d16_d, vals_d = placed["d16"], placed["vals"]
            cidx_d, cval_d = placed["cidx"], placed["cval"]
            refs_d, lens_d, keys_d = (placed["ref_codes"], placed["lens"],
                                      placed["keys"])
            Sp = d16_d.shape[0]
        elif TIMINGS is not None:
            # explicit, synchronized h2d so the benchmark can separate
            # the transfer from the compute (production overlaps it)
            _t_add("h2d_bytes", float(
                d16.nbytes + vals.nbytes + cidx_s.nbytes +
                cval_s.nbytes + refs.nbytes))
            t0 = time.perf_counter()
            d16_d, vals_d, cidx_d, cval_d, refs_d, lens_d, keys_d = [
                jax.block_until_ready(jax.device_put(x))
                for x in (d16, vals, cidx_s, cval_s, refs, lens,
                          keys_arr)]
            _t_add("h2d", time.perf_counter() - t0)
            Sp = Sp0
        else:
            d16_d, vals_d, cidx_d, cval_d = d16, vals, cidx_s, cval_s
            refs_d, lens_d, keys_d = refs, lens, keys_arr
            Sp = Sp0
        snp_cap = min(caps["snp"], Mp * Lp)
        pos_cap = min(caps["pos"], Lp)
        rpos_cap = min(caps["rpos"], Lp)
        skey = ("spb", (Sp, Mp, 4, Lp), vals.shape[1], cidx_s.shape[1],
                snp_cap, pos_cap, rpos_cap, with_dense, min_cov,
                rarefied_coverage)
        if watch is not None:
            # dispatch may block through h2d + kernel completion or
            # return at once with the wait landing on the fetch; either
            # way this is the stall-prone window
            watch.enter("launch")
        t0 = time.perf_counter()
        res = site_stats_compact_batch_sparse(
            d16_d, vals_d, cidx_d, cval_d, refs_d, lens_d, null_lut,
            freq_lut, keys_d, shape=(Mp, 4, Lp), min_cov=min_cov,
            min_covR=rarefied_coverage,
            rarefied_draws=rarefied_coverage, snp_capacity=snp_cap,
            pos_capacity=pos_cap, rpos_capacity=rpos_cap,
            with_dense=with_dense, spec_key=skey)
        if TIMINGS is not None:
            jax.block_until_ready(res)
        _t_add("compute", time.perf_counter() - t0)
        if watch is not None:
            watch.launch_done(time.perf_counter() - t0)
        rec.update(kind="sparse", res=res, skey=skey, caps=caps,
                   rpos_cap=rpos_cap)
    else:
        from ..kernels.sitestats import site_stats_compact_batch
        counts = np.zeros((Sp0, Mp, 4, Lp), np.int32)
        for k, (_i, pu, _rc) in enumerate(part):
            if pu.true_M is not None and pu.counts.shape[0] == Mp:
                counts[k] = pu.counts
            else:
                ce = pu.counts_exact
                M, _, L = ce.shape
                counts[k, :M, :, :L] = ce
        if mesh is not None:
            from ..parallel.mesh import place_batch_sharded
            placed = place_batch_sharded(
                dict(counts=counts, ref_codes=refs, lens=lens,
                     keys=keys_arr), mesh)
            counts_d, refs_d = placed["counts"], placed["ref_codes"]
            lens_d, keys_d = placed["lens"], placed["keys"]
        else:
            counts_d, refs_d, lens_d, keys_d = counts, refs, lens, keys_arr
        res = site_stats_compact_batch(
            counts_d, refs_d, lens_d, null_lut, freq_lut, keys_d,
            min_cov=min_cov, min_covR=rarefied_coverage,
            rarefied_draws=rarefied_coverage, snp_capacity=SNP_CAPACITY,
            pos_capacity=POS_CAPACITY, with_dense=with_dense)
        rec.update(kind="i32", res=res)
    return rec


def _finish_batch_chunk(rec, results, min_cov, with_dense, emit=None,
                        watch=None):
    """Fetch one dispatched chunk's wire, unpack, and slice per-scaffold
    stats into `results`. Scaffolds that overflowed the wire capacities
    stay None (the caller re-runs them per-scaffold) and raise the
    bucket's speculative high-water marks for later launches. `emit` is
    called with every (index, stats-or-None) as it lands (the streaming
    overlap path, iter_site_stats_compact_batch)."""
    part, Mp, Lp = rec["part"], rec["Mp"], rec["Lp"]
    if rec["kind"] == "sparse":
        from ..kernels.sitestats import unpack_wire
        if watch is not None:
            watch.enter("fetch")
        t0 = time.perf_counter()
        wire = np.asarray(rec["res"][0])
        _t_add("fetch", time.perf_counter() - t0)
        _t_add("fetch_bytes", float(wire.nbytes))
        if watch is not None:
            watch.enter("idle")
        out = unpack_wire(wire, rec["skey"])
        clonR_sp = out.pop("clonR_sparse", None)
        wire_sp = True
        cum_overflow = out["linkage"].pop("cum_overflow")
        caps = rec["caps"]
    else:
        out = jax.device_get(rec["res"])
        wire_sp = False
        clonR_sp = None
        cum_overflow = np.zeros(len(part), bool)
        caps = None
    dense = out.pop("dense", None)
    for k, (i, pu, _rc) in enumerate(part):
        if pu.true_M is not None:
            M, L = pu.true_M, pu.length
        else:
            M, _, L = pu.counts.shape
        sliced = {
            grp: {name: np.asarray(v[k]) for name, v in d.items()}
            for grp, d in out.items()
        }
        cls = HybridStats if with_dense else CompactStats
        results[i] = cs = cls.__new__(cls)
        cs.pileup = pu
        cs.M, cs.L = M, L
        cs.rows = sliced["rows"]
        cs.agg = {kk: v[:M] for kk, v in sliced["agg"].items()}
        cs.linkage = sliced["linkage"]
        cs.masks = sliced["masks"]
        if wire_sp:
            cs.masks = _unpack_wire_masks(cs.masks, Lp)
            cs.linkage["cum"] = cs.linkage["cum"].astype(np.int32)
        if with_dense:
            if wire_sp:
                def make_dense(pu=pu, M=M, k=k):
                    # deferred to first access: this native reconstruction
                    # runs on the CONSUMER thread (overlapping launches),
                    # not here on the device-loop thread (see HybridStats)
                    from ..io.bam import clon_cum16
                    c16 = pu.counts if pu.counts.dtype == np.int16 \
                        else pu.counts.astype(np.int16)
                    total, clon = clon_cum16(c16, M, min_cov)
                    return {"total": total, "clon": clon,
                            "clonR": _clonR_from_sparse(clonR_sp, k,
                                                        Mp, Lp)}
                cs._dense_fn = make_dense
            else:
                cs.dense = {kk: np.asarray(v[k])
                            for kk, v in dense.items()}
        n_rows = int(cs.rows["n_rows"])
        n_pos = int(cs.linkage["n_pos"])
        # gathered-rarefied capacity overflow (incomplete clonR
        # aggregates) applies in every sparse mode
        n_rar = int(cs.linkage.pop("n_rar", 0)) if wire_sp else 0
        rpos_cap = rec["rpos_cap"] if wire_sp else 0  # launch's actual cap
        if (n_rows > len(cs.rows["pos"]) or
                n_pos > len(cs.linkage["pos"]) or
                (wire_sp and n_rar > rpos_cap) or
                bool(cum_overflow[k])):
            # overflowed the batch wire capacity -> re-run per-scaffold;
            # raise this bucket's speculative high-water mark for later
            # launches (sparse wire only — int32 uses fixed capacities)
            if wire_sp:
                caps["snp"] = max(caps["snp"],
                                  _pow2_capacity(n_rows, lo=256))
                caps["pos"] = max(caps["pos"],
                                  _pow2_capacity(n_pos, lo=256))
                caps["rpos"] = max(caps["rpos"],
                                   _pow2_capacity(n_rar, lo=256))
            results[i] = None
        if emit is not None:
            emit(i, results[i])


def _bucket_of(pu):
    """Chunking bucket: padded shape PLUS wire dtype — an int32-fallback
    scaffold (deep-coverage int16 overflow) must never share a chunk
    with int16 scaffolds, whose sparse-wire chunk size is ~50x larger
    than the dense formula allows (a mixed chunk would either blow the
    launch byte bound or shrink every later sparse launch)."""
    if pu.true_M is not None:
        Mp, _, Lp = pu.counts.shape
    else:
        M, _, L = pu.counts.shape
        Mp, Lp = max(_bucket(M, 8), 8), max(_bucket(L, 4096), 4096)
    return Mp, Lp, pu.counts.dtype == np.int16


def _chunk_base(Mp: int, Lp: int, is16: bool, with_dense: bool,
                max_chunk_bytes: int) -> int:
    """Power-of-two scaffolds-per-launch for a bucket.

    Wire bytes per scaffold: the sparse path moves delta-encoded nonzero
    entries (the bucket's "vals" high-water mark) + ref codes in, and
    only the compact outputs + sparse clonR out; the int32 fallback
    sends full-width dense counts and fetches dense outputs. Each launch
    pays a fixed dispatch and copy cost, so undersized chunks cost more
    than oversized; the second bound caps the launch's DENSE device working
    set (the kernel densifies to [S, Mp, 4, Lp] int32 + comparable
    intermediates)."""
    if is16:
        per_scaffold = (3 * _bucket_caps((Mp, 4, Lp))["vals"] + Lp)
    else:
        per_scaffold = (Mp * Lp * (12 if with_dense else 4) +
                        4 * Mp * 4 * Lp)
    cap = max(1, min(max_chunk_bytes // per_scaffold,
                     (1 << 27) // (Mp * 4 * Lp)))
    return 1 << (cap.bit_length() - 1)


def run_site_stats_compact_stream(items_iter, null_lut, freq_lut,
                                  min_cov: int = 5,
                                  rarefied_coverage: int = 50,
                                  seed: int = 42,
                                  with_dense: bool = False,
                                  max_chunk_bytes: int = 32 << 20,
                                  mesh=None, pipeline_depth: int = 1,
                                  watch=None, emit=None,
                                  results: Optional[Dict] = None):
    """
    STREAMING batch core: consume (index, pileup, ref_codes) items as
    they become available and dispatch one vmapped kernel launch per
    full power-of-two chunk of same-(Mp, Lp)-bucket scaffolds — the
    first launch goes out as soon as the first chunk fills, while the
    producer is still building later pileups (the reference's analogue
    streams split workers into merge workers,
    profile_controller.py:157-193).

    Chunking matches the former list-based planner exactly: launches
    come in pow2 sizes <= the bucket's base (remainders padded UP to
    the next pow2) so compiled kernel shapes form a tiny reusable set
    with minimal dead-slot padding. Fetching a chunk's results blocks
    until its kernel completes but releases the GIL, so with
    pipeline_depth=1 each chunk's results are finished (and emitted to
    the consumer thread) before the next launch — host table building
    overlaps device compute. `results` (dict or list) receives index ->
    stats.
    """
    from collections import deque

    if results is None:
        results = {}
    depth = 1 if TIMINGS is not None else max(1, int(pipeline_depth))
    pending = deque()
    open_items: Dict = {}
    base_of: Dict = {}

    def dispatch(part, Mp, Lp, pad_to):
        # the sparse wire needs int16 counts (native padded-builder
        # pileups pack zero-copy; ragged int16 via per-scaffold temps)
        use_sparse = (all(pu.counts.dtype == np.int16
                          for _, pu, _ in part) and
                      pad_to * Mp * 4 * Lp < (1 << 31))
        pending.append(_dispatch_batch_chunk(
            part, Mp, Lp, use_sparse, null_lut, freq_lut, min_cov,
            rarefied_coverage, seed, with_dense, mesh, pad_to=pad_to,
            watch=watch))
        while len(pending) > depth:
            _finish_batch_chunk(pending.popleft(), results, min_cov,
                                with_dense, emit=emit, watch=watch)

    for item in items_iter:
        i, pu, rc = item
        key = _bucket_of(pu)
        lst = open_items.setdefault(key, [])
        lst.append((i, pu, rc))
        if key not in base_of:
            base_of[key] = _chunk_base(
                key[0], key[1], key[2], with_dense, max_chunk_bytes)
        if len(lst) >= base_of[key]:
            open_items[key] = []
            dispatch(lst, key[0], key[1], pad_to=len(lst))

    # leftovers: same pow2 decomposition as the planner (mid chunks of
    # descending pow2 sizes, final tail padded up to the next pow2)
    for (Mp, Lp, is16), items in open_items.items():
        c0, n = 0, len(items)
        while c0 < n:
            take = base_of[(Mp, Lp, is16)]
            while take > n - c0:
                take >>= 1
            if take < n - c0:
                part = items[c0:c0 + take]
                pad_to = take
            else:
                part = items[c0:]
                pad_to = 1 << max(0, (len(part) - 1)).bit_length()
            c0 += len(part)
            dispatch(part, Mp, Lp, pad_to=pad_to)

    while pending:
        _finish_batch_chunk(pending.popleft(), results, min_cov,
                            with_dense, emit=emit, watch=watch)
    return results


def run_site_stats_compact_batch(pileups, ref_codes_list, null_lut,
                                 freq_lut, min_cov: int = 5,
                                 rarefied_coverage: int = 50,
                                 seed: int = 42, with_dense: bool = False,
                                 max_chunk_bytes: int = 32 << 20,
                                 mesh=None, pipeline_depth: int = 1,
                                 watch=None,
                                 emit=None):
    """
    Batch same-bucket scaffolds through one kernel launch each (see
    run_site_stats_compact_stream — this is the list-in/list-out
    wrapper over the streaming core).

    With `with_dense` the dense total/clon arrays are reconstructed
    natively on host from the counts we already hold and only the sparse
    clonR rides the wire; results are HybridStats (usable by the full
    profile pipeline). Buckets are chunked so one launch moves at most
    ~max_chunk_bytes.

    With `mesh`, each chunk's stack is sharded along the scaffold axis
    across the device mesh (parallel/mesh.py) — the multi-chip analogue
    of the reference's split-worker pool (profile_controller.py:157-193);
    per-scaffold results are bit-identical to the unsharded batch.

    Returns list of CompactStats/HybridStats in input order.
    """
    results = [None] * len(pileups)
    run_site_stats_compact_stream(
        ((i, pu, rc) for i, (pu, rc)
         in enumerate(zip(pileups, ref_codes_list))),
        null_lut, freq_lut, min_cov=min_cov,
        rarefied_coverage=rarefied_coverage, seed=seed,
        with_dense=with_dense, max_chunk_bytes=max_chunk_bytes,
        mesh=mesh, pipeline_depth=pipeline_depth, watch=watch,
        emit=emit, results=results)
    return results


def iter_site_stats_compact_batch(pileups, ref_codes_list, null_lut,
                                  freq_lut, in_queue=None, **kwargs):
    """Streaming batch runner: yields (index, stats_or_None) as each
    launch's results land, with the device loop in a BACKGROUND THREAD.

    Device calls release the GIL while blocked, so the
    consumer's host-side work (per-scaffold table building, linkage,
    gene profiling — several seconds for 100+ scaffolds) overlaps the
    device wall time instead of following it. A worker failure is
    re-raised here after all landed results have been yielded — callers
    treat un-yielded scaffolds as engine-failed and retry per-scaffold
    (the reference never dies on one bad unit,
    profile_utilities.py:92-112).

    With `in_queue` (a Queue of (index, pileup, ref_codes) items, None
    as end-of-input sentinel), `pileups`/`ref_codes_list` are ignored
    and the device thread consumes items AS THE PRODUCER ENQUEUES THEM —
    the first launch dispatches once the first shape-bucket chunk fills,
    overlapping the producer's remaining pileup builds with device
    compute (the streaming host-stage/device-loop overlap)."""
    import logging
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue()
    err = []
    watch = LaunchWatch()
    stop = threading.Event()

    def drain_in_queue():
        while True:
            item = in_queue.get()
            if item is None:
                return
            yield item

    def work():
        try:
            # call through the module attributes so test monkeypatching
            # intercepts these paths too
            import sys
            mod = sys.modules[__name__]
            if in_queue is not None:
                mod.run_site_stats_compact_stream(
                    drain_in_queue(), null_lut, freq_lut,
                    emit=lambda i, s: q.put((i, s)), watch=watch,
                    **kwargs)
            else:
                mod.run_site_stats_compact_batch(
                    pileups, ref_codes_list, null_lut, freq_lut,
                    emit=lambda i, s: q.put((i, s)), watch=watch,
                    **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            err.append(e)
        finally:
            q.put(None)

    def monitor():
        # launch stall watchdog: a launch blocked far beyond the trailing
        # median gets a WARNING with phase attribution instead of a
        # silent hang. Observational only — it never interrupts the
        # device call; on an engine ERROR the unfinished scaffolds
        # already retry per-scaffold.
        warned_at = -1e9
        while not stop.wait(STALL_CHECK_S):
            phase, dur, hist = watch.snapshot()
            if phase == "idle":
                continue
            med = float(np.median(hist)) if hist else STALL_FLOOR_S
            limit = max(STALL_FACTOR * med, STALL_FLOOR_S)
            now = time.perf_counter()
            if dur > limit and now - warned_at > 6 * STALL_CHECK_S:
                logging.warning(
                    f"launch stall: batch launch phase '{phase}' blocked "
                    f"{dur:.0f}s (trailing-median launch {med:.1f}s, "
                    f"{len(hist)} completed); "
                    f"the run continues when the call returns, and "
                    f"unfinished scaffolds retry per-scaffold if the "
                    f"engine errors")
                warned_at = now

    t = threading.Thread(target=work, daemon=True,
                         name="instrain-batch-device")
    m = threading.Thread(target=monitor, daemon=True,
                         name="instrain-batch-watchdog")
    # threads start EAGERLY (this is a plain function returning a
    # generator, not a generator function): with in_queue streaming, the
    # device thread must be consuming while the caller is still
    # producing pileups, before any result is pulled
    t.start()
    m.start()

    def results():
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            t.join()
        finally:
            stop.set()
        if err:
            raise err[0]

    return results()
