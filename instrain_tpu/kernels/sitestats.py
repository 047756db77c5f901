"""
Per-site statistics kernel: the hot core of profiling.

Takes the dense per-scaffold pileup count tensor counts[M, 4, L]
(M = number of distinct read-pair mismatch levels, 4 = ACTG, L = positions)
and produces, for every (mm level, position) cell, the quantities the
reference computes per pileup column in
inStrain/profile/snv_utilities.py:update_snp_table (40-145) and
call_snv_site (147-196):

  - cumulative counts over mm' <= mm (the "mm-level" axis, SURVEY §0)
  - clonality = sum((c_i/total)^2) where total >= min_cov (and a rarefied
    variant drawn at rarefied_coverage)
  - null-model SNV calls: a base is "present" iff its count clears the
    coverage-dependent null threshold AND the min_freq fraction; the
    morphia (allele count) plus consensus/variant bases follow
  - SNP classes (SNS/SNV/con_SNV/pop_SNV/DivergentSite/AmbiguousReference)
  - the cryptic-SNV state machine over ascending mm levels

Exact-arithmetic parity: both the null threshold and the frequency cutoff
are integer LUT lookups (see nullmodel.py and freq_min_count_lut), so no
device float comparison can flip a call at a boundary.

Everything is jit-compatible with static shapes; the mm axis only includes
levels observed on the scaffold, and cells where the exact-mm coverage is
zero are masked out (the reference only visits present levels).
"""

from __future__ import annotations

import functools
import os
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

# Ablation switches (perf attribution only — results are WRONG when any
# is set): comma-separated stage names in INSTRAIN_ABLATE replace that
# stage with a shape-compatible stub at trace time, so compiled-variant
# timings isolate each stage's real cost on hardware. Used by
# .scratch/ablate_kernel.py; never set in production or tests.
_ABLATE = frozenset(
    x for x in os.environ.get("INSTRAIN_ABLATE", "").split(",") if x)

# class codes (order matches reference string names for table emission)
CLASS_NAMES = ["SNS", "SNV", "con_SNV", "pop_SNV", "DivergentSite",
               "AmbiguousReference"]
SNS, SNV, CON_SNV, POP_SNV, DIVERGENT, AMBIG = range(6)

# call codes
CALL_UNCOUNTED = -2  # coverage below min_cov (reference: None)
CALL_NOSNP = -1      # one dominant reference base (reference: -1)


def freq_min_count_lut(min_freq: float, max_coverage: int = 10000) -> np.ndarray:
    """
    LUT: for each total coverage T, the smallest count c with
    float64(c / T) >= min_freq — reproducing the reference's float division
    semantics (snv_utilities.py:179) with integer comparisons on device.
    """
    T = np.arange(max_coverage + 1, dtype=np.float64)
    c = np.ceil(min_freq * T).astype(np.int64)
    # fix boundary rounding: the true smallest c may be c-1 or c+1
    for delta in (-1, 0, 1):
        cc = c + delta
        with np.errstate(divide="ignore", invalid="ignore"):
            ok = (cc.astype(np.float64) / np.maximum(T, 1)) >= min_freq
        c = np.where(ok & (cc >= 0), np.minimum(c, cc), c)
    c[0] = 0
    return c.astype(np.int32)


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11 — the same
    permutation JAX's default PRNG uses), on uint32 lanes. Implemented
    directly so the rarefied draws can be evaluated at ARBITRARY
    (draw, position) counter values: the value at a given counter is
    independent of array shape, so a kernel that draws only at gathered
    qualifying positions is bit-identical to one that draws densely
    (and to any sharded variant — position indices are global iotas)."""
    ks0, ks1 = k0, k1
    ks2 = jnp.uint32(0x1BD11BDA) ^ ks0 ^ ks1

    def four(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = (x1 << r) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        return x0, x1

    ra = (13, 15, 26, 6)
    rb = (17, 29, 16, 24)
    x0 = x0 + ks0
    x1 = x1 + ks1
    x0, x1 = four(x0, x1, ra)
    x0 = x0 + ks1
    x1 = x1 + ks2 + jnp.uint32(1)
    x0, x1 = four(x0, x1, rb)
    x0 = x0 + ks2
    x1 = x1 + ks0 + jnp.uint32(2)
    x0, x1 = four(x0, x1, ra)
    x0 = x0 + ks0
    x1 = x1 + ks1 + jnp.uint32(3)
    x0, x1 = four(x0, x1, rb)
    x0 = x0 + ks1
    x1 = x1 + ks2 + jnp.uint32(4)
    x0, x1 = four(x0, x1, ra)
    x0 = x0 + ks2
    x1 = x1 + ks0 + jnp.uint32(5)
    return x0, x1


def _key_words(rng_key):
    """(k0, k1) uint32 words from a raw uint32[2] key array or a typed
    PRNG key."""
    if jnp.issubdtype(jnp.asarray(rng_key).dtype, jax.dtypes.prng_key):
        rng_key = jax.random.key_data(rng_key)
    rng_key = jnp.asarray(rng_key, dtype=jnp.uint32)
    return rng_key[0], rng_key[1]


def _ctr_uniform(k0, k1, ctr0, ctr1):
    """Uniform [0, 1) float32 at counter (ctr0, ctr1) under key
    (k0, k1): first threefry output word, mantissa-stuffed into [1, 2)
    and shifted down (the same bits->float construction
    jax.random.uniform uses)."""
    b0, _ = _threefry2x32(k0, k1, ctr0.astype(jnp.uint32),
                          ctr1.astype(jnp.uint32))
    f = jax.lax.bitcast_convert_type(
        (b0 >> 9) | jnp.uint32(0x3F800000), jnp.float32)
    return f - jnp.float32(1.0)


def _clonR_values(rng_key, cdf, pos_idx, rarefied_draws: int):
    """Rarefied clonality values from `rarefied_draws` categorical draws
    of the per-base cumulative probabilities.

    cdf: [M, 4, P] cumulative base probabilities; pos_idx: [P] GLOBAL
    (padded-axis) position indices; returns [M, P] sum(p_i^2) over the
    drawn base frequencies (snv_utilities.py:233-247's
    np.random.choice(reads, rarefied_coverage) resample, with a
    counter-based PRNG: draw d at mm row m, position p uses counter
    (d*M + m, p) — identical values for any P/gather pattern)."""
    M = cdf.shape[0]
    P = cdf.shape[2]
    if "draws" in _ABLATE:
        return cdf[:, 0, :] * 0.0
    k0, k1 = _key_words(rng_key)
    m_idx = jnp.arange(M, dtype=jnp.uint32)[:, None]         # [M, 1]
    p_idx = pos_idx.astype(jnp.uint32)[None, :]              # [1, P]

    def draw(carry, d):
        u = _ctr_uniform(k0, k1, d * jnp.uint32(M) + m_idx,
                         jnp.broadcast_to(p_idx, (M, P)))    # [M, P]
        cat = (u[:, None, :] > cdf[:, :3, :]).sum(axis=1)    # [M, P] 0..3
        onehot = (cat[:, None, :] ==
                  jnp.arange(4, dtype=cat.dtype)[None, :, None])
        return carry + onehot.astype(jnp.float32), None

    rcounts, _ = jax.lax.scan(
        draw, jnp.zeros((M, 4, P), jnp.float32),
        jnp.arange(rarefied_draws, dtype=jnp.uint32))
    rp = rcounts / float(rarefied_draws)
    return (rp * rp).sum(axis=1)                             # [M, P]


@functools.partial(
    jax.jit,
    static_argnames=("min_cov", "min_covR", "rarefied_draws",
                     "with_clonR"))
def site_stats(counts, ref_codes, null_lut, freq_lut, rng_key,
               min_cov: int = 5, min_covR: int = 50,
               rarefied_draws: int = 50,
               with_clonR: bool = True) -> Dict[str, jnp.ndarray]:
    """
    Args:
      counts: int32 [M, 4, L] — exact-mm base counts per position
      ref_codes: uint8 [L] — reference base codes (A0 C1 T2 G3, 4=other)
      null_lut: int32 [maxcov+1] — null-model min alternate count by coverage
      freq_lut: int32 [maxcov+1] — min count satisfying min_freq by coverage
      rng_key: PRNG key for the rarefied draws

    Returns dict of [M, L]-shaped arrays (see kernel docstring) plus
    position-level [L] summaries.
    """
    M, B, L = counts.shape
    maxcov = null_lut.shape[0] - 1
    # int16 inputs (native padded builder, half the transfer bytes) widen
    # on device before any accumulation
    counts = counts.astype(jnp.int32)

    exact_total = counts.sum(axis=1)                    # [M, L]
    present = exact_total > 0                           # [M, L]

    cum = jnp.cumsum(counts, axis=0)                    # [M, 4, L]
    total = cum.sum(axis=1)                             # [M, L]
    total_c = jnp.minimum(total, maxcov)

    # ---- null-model base presence ----
    min_bases = null_lut[total_c]                       # [M, L]
    freq_min = freq_lut[total_c]                        # [M, L]
    thresh = jnp.maximum(min_bases, freq_min)[:, None, :]
    base_present = cum >= thresh                        # [M, 4, L]
    morphia = base_present.sum(axis=1).astype(jnp.int8)  # [M, L]

    # consensus base: argmax over ACTG (ties -> lowest code, like np.argmax)
    con = jnp.argmax(cum, axis=1).astype(jnp.int8)      # [M, L]
    # var base: argmax after zeroing consensus
    con_onehot = jax.nn.one_hot(con, 4, axis=1, dtype=cum.dtype)  # [M,4,L]
    cum_novar = cum * (1 - con_onehot)
    var = jnp.argmax(cum_novar, axis=1).astype(jnp.int8)

    counted = total >= min_cov                          # [M, L]
    ref_b = ref_codes.astype(jnp.int32)                 # [L]
    con_is_ref = con.astype(jnp.int32) == ref_b[None, :]

    # call: base (0..3) if morphia>1, or morphia==1 & con!=ref, or
    # morphia==0; else NOSNP; UNCOUNTED if total<min_cov
    is_base_call = (morphia > 1) | ((morphia == 1) & ~con_is_ref) | (morphia == 0)
    call = jnp.where(is_base_call, con.astype(jnp.int8),
                     jnp.int8(CALL_NOSNP))
    call = jnp.where(counted, call, jnp.int8(CALL_UNCOUNTED))

    # a table row is emitted at (mm, pos) iff the level is present at the
    # position and the call is a base (update_snp_table:104-127)
    row = present & counted & is_base_call              # [M, L]

    # ---- SNP class ----
    # ref base count at cumulative level
    ref_sel = jax.nn.one_hot(jnp.clip(ref_b, 0, 3), 4, axis=0,
                             dtype=cum.dtype)           # [4, L]
    ref_count = (cum * ref_sel[None, :, :]).sum(axis=1)  # [M, L]
    ref_present = (ref_count >= min_bases) & (ref_count >= freq_min)
    var_is_ref = var.astype(jnp.int32) == ref_b[None, :]

    cls = jnp.where(
        ref_b[None, :] >= 4, jnp.int8(AMBIG),
        jnp.where(
            morphia == 0, jnp.int8(DIVERGENT),
            jnp.where(
                morphia == 1, jnp.int8(SNS),
                jnp.where(
                    con_is_ref, jnp.int8(SNV),
                    jnp.where(var_is_ref | ref_present,
                              jnp.int8(CON_SNV), jnp.int8(POP_SNV))))))

    # ---- clonality ----
    totf = total.astype(jnp.float32)
    with jax.numpy_dtype_promotion("standard"):
        p = cum.astype(jnp.float32) / jnp.maximum(totf, 1.0)[:, None, :]
    clon_val = (p * p).sum(axis=1)                      # [M, L]
    clon_set = present & counted
    clon = jnp.where(clon_set, clon_val, jnp.nan)

    # ---- rarefied clonality (multinomial draw of rarefied_draws reads) ----
    clonR_set = present & (total >= min_covR)
    # categorical draws via cumulative probabilities with counter-based
    # threefry uniforms (see _clonR_values): with_clonR=False skips the
    # draw loop entirely and hands `cdf` back so the caller can draw at
    # GATHERED qualifying positions only — bit-identical values, a tiny
    # fraction of the work when few positions reach rarefied coverage
    cdf = jnp.cumsum(p, axis=1)                         # [M, 4, L]
    if with_clonR:
        clonR_val = _clonR_values(rng_key, cdf,
                                  jnp.arange(L, dtype=jnp.uint32),
                                  rarefied_draws)       # [M, L]
        clonR = jnp.where(clonR_set, clonR_val, jnp.nan)
    else:
        clonR = jnp.broadcast_to(jnp.float32(jnp.nan), (M, L))

    # ---- cryptic state machine over ascending mm ----
    emits_snp = row & (morphia >= 2)                    # anySNP trigger
    any_snp_incl = jnp.cumsum(emits_snp.astype(jnp.int32), axis=0) > 0
    any_snp_before = jnp.concatenate(
        [jnp.zeros((1, L), dtype=bool), any_snp_incl[:-1]], axis=0)
    cryptic_here = present & counted & any_snp_before & (
        (call == CALL_NOSNP) | (morphia == 1))
    cryptic = cryptic_here.any(axis=0)                  # [L]

    # linkage support: positions flagged anySNP at the end, and the union
    # of {con, var} bases over morphia>=2 rows (profile/linkage.py:254-283)
    any_snp = any_snp_incl[-1]                          # [L]
    m2 = emits_snp
    con_oh = jax.nn.one_hot(con, 4, axis=1, dtype=jnp.int32)
    var_oh = jax.nn.one_hot(var, 4, axis=1, dtype=jnp.int32)
    bases_mask = (((con_oh | var_oh) * m2[:, None, :]).sum(axis=0) > 0)  # [4, L]

    out = dict(
        present=present, cum=cum, total=total, morphia=morphia,
        con=con, var=var, call=call, row=row, cls=cls,
        clon=clon, clonR=clonR, clonR_set=clonR_set,
        cryptic=cryptic, any_snp=any_snp, bases_mask=bases_mask,
        ref_count=ref_count,
    )
    if not with_clonR:
        out["cdf"] = cdf
    return out


# ---------------------------------------------------------------------------
# Compact variant: computes table-ready, small outputs ON DEVICE so that
# device->host transfers stay tiny (host links are orders of magnitude
# slower than device memory). The dense
# per-position arrays never leave the device; instead we emit:
#   - fixed-capacity compacted SNP rows (position-major order)
#   - per-mm scaffold aggregates (every quantity make_coverage_table needs)
#   - fixed-capacity per-SNV-position cumulative count profiles (linkage)
#   - small position-level bitmasks (cryptic / any_snp / bases_mask)
# ---------------------------------------------------------------------------


def _ffill_scan(vals, set_mask, fill):
    """out[m] = vals at the highest m' <= m where set (else fill)."""
    def step(carry, x):
        v, s = x
        new = jnp.where(s, v, carry)
        return new, new
    init = jnp.full_like(vals[0], fill)
    _, out = jax.lax.scan(step, init, (vals, set_mask))
    return out


def _first_set_indices(mask, k: int):
    """Ascending indices of the first k set positions of a 1-D bool
    mask, -1-padded — the jnp.nonzero(size=k, fill_value=-1) contract.

    Implemented with lax.top_k over descending keys instead of
    jnp.nonzero (a cumsum + scatter). The choice was made on the
    previous accelerator, where scatter serialized; whether it still
    pays on the GPU is not measured."""
    n = mask.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, mask.shape, 0)
    key = jnp.where(mask, jnp.int32(n) - iota, jnp.int32(0))
    kk = min(k, n)       # top_k requires k <= n; nonzero allowed k > n
    vals, _ = jax.lax.top_k(key, kk)
    idx = jnp.where(vals > 0, jnp.int32(n) - vals, jnp.int32(-1))
    if kk < k:
        idx = jnp.concatenate(
            [idx, jnp.full(k - kk, -1, dtype=jnp.int32)])
    return idx


def _ffill_expand(vals_list, set_mask, fills):
    """Forward-fill each array down the mm axis (axis 0): out[m] = value
    at the highest m' <= m where set_mask (else that array's fill).
    Returns (filled_list, have) with have[m] = any(set_mask[:m+1]).

    Unrolled Hillis-Steele doubling: ceil(log2(M)) elementwise passes
    that XLA fuses into a handful of kernels, replacing the former
    per-array lax.scan while-loops (four sequential M-iteration loops
    over [S, M, L] operands were ~1 s of the 2.7 s batch launch — the
    round-4 ablation's largest single line item). Bit-identical to
    _ffill_scan per array (asserted in tests)."""
    M = set_mask.shape[0]
    outs = [jnp.where(set_mask, v, jnp.full_like(v, f))
            for v, f in zip(vals_list, fills)]
    if "ffill" in _ABLATE:
        return outs, set_mask
    have = set_mask
    k = 1
    while k < M:
        prev_have = jnp.concatenate(
            [jnp.zeros_like(have[:k]), have[:-k]], axis=0)
        take = ~have & prev_have
        outs = [jnp.where(take,
                          jnp.concatenate(
                              [jnp.full_like(o[:k], f), o[:-k]], axis=0),
                          o)
                for o, f in zip(outs, fills)]
        have = have | prev_have
        k <<= 1
    return outs, have



def _median_select(vals_f32, count):
    """Exact masked median without sorting: vals [R, L] float32 with
    non-members set to +inf, count [R] = members per row.

    PRECONDITION (round-4 advisory): values must be NON-NEGATIVE
    (+inf padding allowed). The search runs on int32 bit patterns,
    which order like the floats only on [0, +inf]; a negative member
    would be silently mis-ranked. Every current caller feeds coverages
    or clonalities (both >= 0).

    UNROLLED binary search for the lower middle order statistic k1: 31
    compare+reduce passes over the tile, each a fused [R, L] compare
    against a per-row scalar pivot — no while loop (the former
    lax.fori_loop bisect paid per-iteration sync overhead, ~0.6 s of
    the 2.7 s batch launch) and no multi-pivot broadcast (a W-way
    variant materialized [R, W, L] tensors — 155 GB of HLO traffic at
    batch shapes — and measured SLOWER than the loop it replaced). The
    upper middle statistic k2 is ADJACENT to k1 (k2 = k1 or k1+1), so
    one extra fused pass recovers it: v2 = v1 when count(<= v1) >= k2,
    else min(vals > v1). Equals the jnp.sort-based median bit for bit
    (asserted in tests)."""
    if "median" in _ABLATE:
        return jnp.where(count > 0, vals_f32[:, 0], jnp.nan)
    bits = jax.lax.bitcast_convert_type(vals_f32, jnp.int32)   # [R, L]
    c = jnp.maximum(count, 1).astype(jnp.int32)
    k1 = (c - 1) // 2 + 1
    k2 = c // 2 + 1
    lo = jnp.zeros_like(k1)
    hi = jnp.full_like(k1, 0x7F800000)   # exclusive; members are finite
    for _ in range(31):                  # 2^31 span -> 1 in 31 halvings
        mid = lo + ((hi - lo) >> 1)
        cnt = (bits <= mid[:, None]).sum(axis=1).astype(jnp.int32)
        t = cnt >= k1
        lo = jnp.where(t, lo, mid + 1)
        hi = jnp.where(t, mid, hi)
    v1b = lo
    # adjacent-stat refine: one more tile pass for the upper middle stat
    le1 = bits <= v1b[:, None]
    cnt1 = le1.sum(axis=1).astype(jnp.int32)
    above_min = jnp.where(le1, jnp.int32(0x7F800000), bits).min(axis=1)
    v2b = jnp.where(cnt1 >= k2, v1b, above_min)
    v1 = jax.lax.bitcast_convert_type(v1b, jnp.float32)
    v2 = jax.lax.bitcast_convert_type(v2b, jnp.float32)
    med = (v1 + v2) / 2.0
    return jnp.where(count > 0, med, jnp.nan)


@functools.partial(
    jax.jit,
    static_argnames=("min_cov", "min_covR", "rarefied_draws",
                     "snp_capacity", "pos_capacity", "true_len"))
def site_stats_compact(counts, ref_codes, null_lut, freq_lut, rng_key,
                       min_cov: int = 5, min_covR: int = 50,
                       rarefied_draws: int = 50,
                       snp_capacity: int = 16384,
                       pos_capacity: int = 8192,
                       true_len: int = 0):
    """Fused site stats with on-device compaction (see block comment)."""
    full = site_stats(counts, ref_codes, null_lut, freq_lut, rng_key,
                      min_cov=min_cov, min_covR=min_covR,
                      rarefied_draws=rarefied_draws)
    Lt = true_len or counts.shape[-1]
    return _compact_from_full(full, counts, snp_capacity, pos_capacity, Lt)


# Batched variant: vmap over a leading scaffold axis. true_len becomes a
# traced per-scaffold array so same-bucket scaffolds share one compile.
@functools.partial(
    jax.jit,
    static_argnames=("min_cov", "min_covR", "rarefied_draws",
                     "snp_capacity", "pos_capacity", "with_dense"))
def site_stats_compact_batch(counts, ref_codes, lens, null_lut, freq_lut,
                             rng_keys, min_cov: int = 5, min_covR: int = 50,
                             rarefied_draws: int = 50,
                             snp_capacity: int = 16384,
                             pos_capacity: int = 8192,
                             with_dense: bool = False):
    """counts [S, M, 4, L], ref_codes [S, L], lens [S], rng_keys [S]."""

    def one(c, r, l, k):
        return _site_stats_compact_traced(
            c, r, null_lut, freq_lut, k, l, min_cov=min_cov,
            min_covR=min_covR, rarefied_draws=rarefied_draws,
            snp_capacity=snp_capacity, pos_capacity=pos_capacity,
            with_dense=with_dense)

    return jax.vmap(one)(counts, ref_codes, lens, rng_keys)


def _site_stats_compact_traced(counts, ref_codes, null_lut, freq_lut,
                               rng_key, true_len, **kw):
    """site_stats_compact with a traced true_len (used under vmap).

    With gather_clonR (the single-dispatch sparse wire paths), the
    rarefied draw loop runs ONLY at the <= rpos_capacity positions where
    some mm level reaches rarefied coverage, instead of densely over
    every (mm, position) cell — the dominant device cost at metagenome
    scale, where typically <1% of positions reach 50x. The counter-based
    PRNG (_clonR_values) makes the gathered values bit-identical to the
    dense path's, so every engine still agrees exactly. When more than
    rpos_capacity positions qualify, `n_rar` in the wire tells the
    caller to retry with a raised capacity (same protocol as the
    SNP-row/linkage capacities)."""
    gather = bool(kw.get("gather_clonR"))
    full = site_stats.__wrapped__(counts, ref_codes, null_lut, freq_lut,
                                  rng_key, min_cov=kw["min_cov"],
                                  min_covR=kw["min_covR"],
                                  rarefied_draws=kw["rarefied_draws"],
                                  with_clonR=not gather)
    clonR_gathered = None
    if gather:
        M, _, L = counts.shape
        cap = kw["rpos_capacity"]
        rset_any = jnp.any(full["clonR_set"], axis=0)        # [L]
        if "nonzero" in _ABLATE:
            ridx = jnp.arange(cap, dtype=jnp.int32) * (
                1 + rset_any[0].astype(jnp.int32))
        else:
            ridx = _first_set_indices(rset_any, cap)
        rvalid = ridx >= 0
        safe = jnp.maximum(ridx, 0)
        vals_g = _clonR_values(rng_key, full["cdf"][:, :, safe],
                               safe, kw["rarefied_draws"])   # [M, cap]
        set_g = full["clonR_set"][:, safe] & rvalid[None, :]
        clonR_g = jnp.where(set_g, vals_g, jnp.nan)
        n_rar = rset_any.sum()
        clonR_gathered = dict(vals=clonR_g, set=set_g, valid=rvalid,
                              pos=jnp.where(rvalid, safe,
                                            -1).astype(jnp.int32),
                              n=n_rar)
    out = _compact_from_full(full, counts, kw["snp_capacity"],
                             kw["pos_capacity"], true_len,
                             clonR_gathered=clonR_gathered)
    if gather:
        # gather-capacity overflow must be detectable in every mode
        out["linkage"]["n_rar"] = clonR_gathered["n"]
    if kw.get("with_dense"):
        if kw.get("dense_device", True):
            out["dense"] = dict(clon=full["clon"], clonR=full["clonR"],
                                total=full["total"].astype(jnp.int32))
        else:
            # u8 wire: the host reconstructs total AND clon natively from
            # the counts it already holds (io.bam.clon_cum16). The
            # PRNG-dependent clonR crosses SPARSELY inside the single
            # packed wire: values only at positions where any mm level
            # reaches rarefied coverage (few in practice — a dense
            # [M, L] f32 fetch used to dominate the transfer)
            out["clonR_sparse"] = dict(
                pos=clonR_gathered["pos"],
                vals=clonR_gathered["vals"].astype(jnp.float32),
                n=clonR_gathered["n"])
    return out


def _compact_from_full(full, counts, snp_capacity, pos_capacity, true_len,
                       clonR_gathered=None):
    M, B, L = counts.shape
    Lt = true_len

    row = full["row"]
    cum = full["cum"]
    total = full["total"]
    clon = full["clon"]
    clonR = full["clonR"]
    present = full["present"]

    flat_pm = row.T.reshape(-1)
    if "nonzero" in _ABLATE:
        ridx = jnp.arange(snp_capacity, dtype=jnp.int32) * (
            1 + flat_pm[0].astype(jnp.int32))
    else:
        ridx = _first_set_indices(flat_pm, snp_capacity)
    valid_rows = ridx >= 0
    safe = jnp.maximum(ridx, 0)
    r_pos = safe // M
    r_mm = safe % M
    rows = dict(
        valid=valid_rows,
        pos=jnp.where(valid_rows, r_pos, -1),
        mm_idx=jnp.where(valid_rows, r_mm, -1),
        A=cum[r_mm, 0, r_pos], C=cum[r_mm, 1, r_pos],
        T=cum[r_mm, 2, r_pos], G=cum[r_mm, 3, r_pos],
        total=total[r_mm, r_pos],
        con=full["con"][r_mm, r_pos], var=full["var"][r_mm, r_pos],
        morphia=full["morphia"][r_mm, r_pos],
        cls=full["cls"][r_mm, r_pos],
        cryptic=full["cryptic"][r_pos],
        n_rows=row.sum(),
    )

    acc_i = jnp.int32 if "agg64" in _ABLATE else jnp.int64
    acc_f = jnp.float32 if "agg64" in _ABLATE else jnp.float64
    pos_ok = (jax.lax.broadcasted_iota(jnp.int32, (1, L), 1) < Lt)
    toti = jnp.where(pos_ok, total, 0).astype(acc_i)
    cov_sum = toti.sum(axis=1)
    cov_sumsq = (toti * toti).sum(axis=1)
    nonzeros = ((total > 0) & pos_ok).sum(axis=1)
    cov_median = _median_select(
        jnp.where(pos_ok, total.astype(jnp.float32), jnp.inf),
        jnp.broadcast_to(jnp.int32(1) * Lt, (M,)))

    clon_set = ~jnp.isnan(clon) & pos_ok
    (clon_f,), has_clon = _ffill_expand([clon], clon_set, [jnp.nan])
    counted = has_clon.sum(axis=1)
    clon_sum = jnp.where(has_clon, clon_f, 0.0).astype(
        acc_f).sum(axis=1)
    clon_median = _median_select(
        jnp.where(has_clon, clon_f, jnp.inf), counted)

    if clonR_gathered is None:
        clonR_set = ~jnp.isnan(clonR) & pos_ok
        (clonR_f,), hasR = _ffill_expand([clonR], clonR_set, [jnp.nan])
    else:
        # clonR exists only at the gathered qualifying positions; the
        # per-column ffill/sum/median over those columns equals the
        # dense computation restricted to them (non-qualifying columns
        # never contribute: hasR is false everywhere on them)
        set_g = clonR_gathered["set"]                      # [M, cap]
        (clonR_f,), hasR = _ffill_expand([clonR_gathered["vals"]],
                                         set_g, [jnp.nan])
    rarefied = hasR.sum(axis=1)
    clonR_sum = jnp.where(hasR, clonR_f, 0.0).astype(
        acc_f).sum(axis=1)
    clonR_median = _median_select(
        jnp.where(hasR, clonR_f, jnp.inf), rarefied)

    # morphia and class share the `row` mask: forward-fill ONE packed
    # int (morphia<<3 | cls) and decode, halving that pass's traffic
    enc = ((full["morphia"].astype(jnp.int32) << 3) |
           full["cls"].astype(jnp.int32))
    (enc_f,), have_any = _ffill_expand([enc], row, [-1])
    have_row = have_any & pos_ok
    mor_f = enc_f >> 3
    cls_f = enc_f & 7
    div_sites = have_row.sum(axis=1)
    sns = (have_row & (mor_f == 1)).sum(axis=1)
    snv = (have_row & (mor_f > 1)).sum(axis=1)
    con_snps = (have_row & ((cls_f == 0) | (cls_f == 2) |
                            (cls_f == 3))).sum(axis=1)
    pop_snps = (have_row & ((cls_f == 0) | (cls_f == 3))).sum(axis=1)

    aggregates = dict(
        cov_sum=cov_sum, cov_sumsq=cov_sumsq, nonzeros=nonzeros,
        cov_median=cov_median, counted=counted, clon_sum=clon_sum,
        clon_median=clon_median, rarefied=rarefied, clonR_sum=clonR_sum,
        clonR_median=clonR_median, div_sites=div_sites, sns=sns, snv=snv,
        con_snps=con_snps, pop_snps=pop_snps,
        mm_active=present.any(axis=1),
    )

    if "nonzero" in _ABLATE:
        pidx = jnp.arange(pos_capacity, dtype=jnp.int32) * (
            1 + full["any_snp"][0].astype(jnp.int32))
    else:
        pidx = _first_set_indices(full["any_snp"], pos_capacity)
    pvalid = pidx >= 0
    psafe = jnp.maximum(pidx, 0)
    linkage = dict(
        valid=pvalid,
        pos=jnp.where(pvalid, psafe, -1),
        cum=cum[:, :, psafe],
        present=present[:, psafe],
        n_pos=full["any_snp"].sum(),
    )

    masks = dict(cryptic=full["cryptic"], any_snp=full["any_snp"],
                 bases_mask=full["bases_mask"])
    return dict(rows=rows, agg=aggregates, linkage=linkage, masks=masks)


@jax.jit
def compact_sizes(full):
    """Tiny fetch: (#SNP rows, #SNV positions) for capacity selection."""
    return full["row"].sum(), full["any_snp"].sum()


@functools.partial(jax.jit, static_argnames=("snp_capacity", "pos_capacity"))
def compact_outputs(full, counts, true_len, snp_capacity: int,
                    pos_capacity: int):
    """Second phase of the two-phase compact path: gather with capacities
    sized from compact_sizes (the full dict stays device-resident between
    the phases, so nothing dense ever crosses the host link)."""
    return _compact_from_full(full, counts, snp_capacity, pos_capacity,
                              true_len)


def _densify_sparse(d16, vals_u8, corr_idx, corr_val, shape):
    """Reconstruct the dense int32 count tensor from the delta-encoded
    sparse wire (uint16 index deltas + uint8 values saturated at 255 +
    int32 corrections at dense flat indices; produced by
    io.bam.pack_counts_sparse_d16_into). idx = cumsum(delta) - 1 over
    the ~5%-density entry list, then one scatter-add — measured ~2x
    faster than the previous bitmap wire's full-length bit-expand +
    cumsum + gather (1.39 s -> 0.72 s per 64-scaffold launch), with a
    smaller wire. Zero-padded tail entries re-add 0 at the last index
    (or index -1 -> wraps, still +0) — self-neutralizing."""
    n = shape[0] * shape[1] * shape[2]
    if "densify" in _ABLATE:
        pad = jnp.zeros(n - vals_u8.shape[0], jnp.int32)
        flat = jnp.concatenate([vals_u8.astype(jnp.int32) +
                                d16[:1].astype(jnp.int32) +
                                corr_val[:1], pad])
        return flat.reshape(shape)
    idx = jnp.cumsum(d16.astype(jnp.int32)) - 1
    cell = jnp.zeros(n, jnp.int32)
    cell = cell.at[idx].add(vals_u8.astype(jnp.int32))
    return cell.at[corr_idx].add(corr_val).reshape(shape)


@functools.partial(
    jax.jit,
    static_argnames=("shape", "min_cov", "min_covR", "rarefied_draws",
                     "snp_capacity", "pos_capacity", "rpos_capacity",
                     "with_dense", "spec_key"))
def site_stats_compact_sparse(d16, vals_u8, corr_idx, corr_val,
                              ref_codes, null_lut, freq_lut, rng_key,
                              true_len, shape,
                              min_cov: int = 5, min_covR: int = 50,
                              rarefied_draws: int = 50,
                              snp_capacity: int = 1024,
                              pos_capacity: int = 1024,
                              rpos_capacity: int = 1024,
                              with_dense: bool = False,
                              spec_key=None):
    """
    Single-dispatch compact path with a minimal wire format, to keep
    host<->device copies small:
      in : delta-encoded sparse counts — uint16 index deltas + uint8
           nonzero values (~5-10% density) + int32 corrections for
           cells > 255 (io.bam.pack_counts_sparse_d16_into); `shape` is
           the static dense (M, 4, L)
      out: _compact_from_full with bit-packed position masks, int16
           linkage counts (+ overflow flag; the caller falls back to the
           two-phase int32 path in the rare >32767-coverage case), and
           with_dense a SPARSE clonR (values only at rarefied-coverage
           positions), all flattened into ONE uint64 wire buffer
           (_pack_out)
    One host->device put, one dispatch, ONE device_get — no capacity
    round-trip (the caller retries with larger static capacities if the
    speculative ones overflow, and value/correction overflow is known at
    pack time, before any launch).
    """
    counts = _densify_sparse(d16, vals_u8, corr_idx, corr_val, shape)
    # dense_device=False: the host reconstructs `total` and `clon`
    # natively from the counts it already holds (io.bam.clon_cum16), so
    # only the PRNG-dependent clonR crosses — sparsely, in the wire;
    # gather_clonR: the rarefied draws run at qualifying positions only
    out = _site_stats_compact_traced(
        counts, ref_codes, null_lut, freq_lut, rng_key, true_len,
        min_cov=min_cov, min_covR=min_covR, rarefied_draws=rarefied_draws,
        snp_capacity=snp_capacity, pos_capacity=pos_capacity,
        rpos_capacity=rpos_capacity, gather_clonR=True,
        with_dense=with_dense, dense_device=False)
    out = _pack_wire(out)
    return _pack_out(out, spec_key)


# Wire specs recorded at trace time, keyed by the caller-supplied static
# spec_key (re-traces repopulate this in new processes; the persistent
# compile cache only skips XLA compilation, never tracing).
_WIRE_SPECS: Dict = {}


# f64 leaves cross the wire as round(x * 2^26) int64 + an f32 residual.
# The only f64 outputs are clon_sum/clonR_sum: sums of <= L f32 clonality
# values, each in [0.25, 1] (sum of squared frequencies over 4 alleles),
# so x * 2^26 is an exact integer <= 2^41 and the residual is exactly 0 —
# the encoding is lossless for them. Any future nonconforming f64 leaf
# degrades gracefully to ~f32-residual accuracy instead of breaking.
_F64_SCALE = float(1 << 26)


def _pack_out(out, spec_key):
    """Flatten an output pytree into ONE flat uint64 buffer: a chunk's
    output has ~40 leaves, and one packed fetch replaces a fetch per
    leaf (built for a link with a high per-fetch latency; whether it
    still pays on the GPU is not measured). <=32-bit leaves (bool as
    uint8) bitcast into a byte stream; int64 leaves ride as-is; float64
    leaves use the exact scaled-int64 + f32-residual encoding (the
    previous accelerator could not bitcast 64-bit element types). Both
    streams concatenate into uint64 words (little-endian byte order,
    asserted by the wire roundtrip tests)."""
    leaves, treedef = jax.tree_util.tree_flatten(out)
    if "pack" in _ABLATE:
        tot = jnp.float32(0)
        for x in leaves:
            tot = tot + jnp.sum(x.astype(jnp.float32))
        return (tot.astype(jnp.uint64).reshape(1),)
    parts8, parts64 = [], []
    spec = []
    for x in leaves:
        f = x.reshape(-1)
        if f.dtype == jnp.bool_:
            f = f.astype(jnp.uint8)
        wd = np.dtype(f.dtype)
        if wd.itemsize == 8:
            if wd.kind == "f":
                spec.append((x.shape, np.dtype(x.dtype), wd, "f64s"))
                f = f.astype(jnp.float64)
                conforming = jnp.isfinite(f) & (jnp.abs(f) < 2.0 ** 36)
                k = jnp.where(conforming,
                              jnp.round(f * _F64_SCALE), 0.0)
                k = k.astype(jnp.int64)
                r = jnp.where(conforming,
                              f - k.astype(jnp.float64) / _F64_SCALE,
                              f).astype(jnp.float32)
                parts64.append(k)
                parts8.append(jax.lax.bitcast_convert_type(
                    r, jnp.uint8).reshape(-1))
            else:
                spec.append((x.shape, np.dtype(x.dtype), wd, "i64"))
                parts64.append(f.astype(jnp.int64))
        else:
            spec.append((x.shape, np.dtype(x.dtype), wd, "u8"))
            b = (f if f.dtype == jnp.uint8
                 else jax.lax.bitcast_convert_type(f, jnp.uint8))
            parts8.append(b.reshape(-1))
    _WIRE_SPECS[spec_key] = (treedef, spec)

    s8 = (jnp.concatenate(parts8) if parts8
          else jnp.zeros(0, dtype=jnp.uint8))
    pad = (-s8.shape[0]) % 8
    if pad:
        s8 = jnp.concatenate([s8, jnp.zeros(pad, dtype=jnp.uint8)])
    w8 = (jax.lax.bitcast_convert_type(s8.reshape(-1, 8), jnp.uint64)
          if s8.shape[0] else jnp.zeros(0, dtype=jnp.uint64))
    s64 = (jnp.concatenate(parts64) if parts64
           else jnp.zeros(0, dtype=jnp.int64))
    w64 = jax.lax.bitcast_convert_type(s64, jnp.uint64)
    return (jnp.concatenate([w8, w64]),)


def unpack_wire(wire, spec_key):
    """Host-side inverse of _pack_out (zero-copy views into the single
    fetched uint64 buffer)."""
    treedef, spec = _WIRE_SPECS[spec_key]
    n8 = sum(int(np.prod(shape, dtype=np.int64)) *
             (4 if stream == "f64s" else wire_dtype.itemsize)
             for shape, dtype, wire_dtype, stream in spec
             if stream in ("u8", "f64s"))
    words8 = (n8 + 7) // 8
    raw = np.ascontiguousarray(wire).view(np.uint8)
    flat8 = raw[:n8]
    flat64 = raw[words8 * 8:].view("<i8")
    leaves = []
    off8 = 0
    off64 = 0
    for shape, dtype, wire_dtype, stream in spec:
        cnt = int(np.prod(shape, dtype=np.int64))
        if stream == "u8":
            n = cnt * wire_dtype.itemsize
            buf = flat8[off8:off8 + n]
            if dtype == np.bool_:
                arr = buf.view(np.bool_).reshape(shape)
            else:
                arr = buf.view(dtype).reshape(shape)
            off8 += n
        elif stream == "i64":
            arr = flat64[off64:off64 + cnt].view(dtype).reshape(shape)
            off64 += cnt
        else:  # f64s: scaled int64 + f32 residual
            k = flat64[off64:off64 + cnt]
            off64 += cnt
            r = flat8[off8:off8 + cnt * 4].view(np.float32)
            off8 += cnt * 4
            arr = (k.astype(np.float64) / _F64_SCALE +
                   r.astype(np.float64)).reshape(shape)
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _pack_wire(out):
    """Shrink a compact-output dict to the minimal wire format: bit-packed
    masks + int16 linkage counts with a per-scaffold overflow flag (the
    consumer falls back to the per-scaffold int32 path on overflow)."""
    m = out["masks"]
    out["masks"] = dict(cryptic=jnp.packbits(m["cryptic"], axis=-1),
                        any_snp=jnp.packbits(m["any_snp"], axis=-1),
                        bases_mask=jnp.packbits(m["bases_mask"], axis=-1))
    lk = out["linkage"]
    packed = dict(
        valid=lk["valid"], pos=lk["pos"], present=lk["present"],
        n_pos=lk["n_pos"],
        cum=jnp.minimum(lk["cum"], 32767).astype(jnp.int16),
        cum_overflow=(lk["cum"].max() > 32767))
    if "n_rar" in lk:
        packed["n_rar"] = lk["n_rar"]
    out["linkage"] = packed
    return out


@functools.partial(
    jax.jit,
    static_argnames=("shape", "min_cov", "min_covR", "rarefied_draws",
                     "snp_capacity", "pos_capacity", "rpos_capacity",
                     "with_dense", "spec_key"))
def site_stats_compact_batch_sparse(d16, vals_u8, corr_idx, corr_val,
                                    ref_codes, lens, null_lut, freq_lut,
                                    rng_keys, shape,
                                    min_cov: int = 5, min_covR: int = 50,
                                    rarefied_draws: int = 50,
                                    snp_capacity: int = 1024,
                                    pos_capacity: int = 1024,
                                    rpos_capacity: int = 1024,
                                    with_dense: bool = False,
                                    spec_key=None):
    """Batched (vmapped) variant of site_stats_compact_sparse: per
    scaffold [V] uint16 index deltas + [V] u8 values + [C] corrections
    (within-scaffold flat index / value, zero-padded — so each
    scaffold's densify stays scaffold-local and the whole launch shards
    along S over a device mesh); `shape` is the static per-scaffold
    dense (Mp, 4, Lp). Per-scaffold packed masks / int16
    linkage counts / overflow flags; with_dense rides a per-scaffold
    SPARSE clonR in the wire (`total`/`clon` are host-reconstructed,
    see io.bam.clon_cum16). Returns ONE packed uint64 wire buffer."""

    def one(mk, vl, ci, cv, r, l, k):
        c = _densify_sparse(mk, vl, ci, cv, shape)
        out = _site_stats_compact_traced(
            c, r, null_lut, freq_lut, k, l, min_cov=min_cov,
            min_covR=min_covR, rarefied_draws=rarefied_draws,
            snp_capacity=snp_capacity, pos_capacity=pos_capacity,
            rpos_capacity=rpos_capacity, gather_clonR=True,
            with_dense=with_dense, dense_device=False)
        return _pack_wire(out)

    out = jax.vmap(one)(d16, vals_u8, corr_idx, corr_val, ref_codes,
                        lens, rng_keys)
    return _pack_out(out, spec_key)


@functools.partial(jax.jit, static_argnames=("snp_capacity", "pos_capacity"))
def compact_outputs_with_dense(full, counts, true_len, snp_capacity: int,
                               pos_capacity: int):
    """compact_outputs plus the dense arrays the profile pipeline stores
    (clonality values for clonT/clonTR, cumulative totals for gene
    profiling) — everything else stays on device."""
    out = _compact_from_full(full, counts, snp_capacity, pos_capacity,
                             true_len)
    out["dense"] = dict(total=full["total"].astype(jnp.int32),
                        clon=full["clon"], clonR=full["clonR"])
    return out
