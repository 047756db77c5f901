"""
Per-scaffold pileup construction and profiling.

Replaces the reference's pysam pileup loop (profile/profile_utilities.py:
115-286) with a dense-tensor pipeline: decoded base events of filtered
read pairs scatter into counts[M, 4, L] (M = distinct pair-mismatch levels
on the scaffold), then the site_stats kernel computes clonality, SNV calls
and the cryptic scan for every (mm, position) cell in one fused pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.bam import BamArrays
from ..kernels import nullmodel
from ..kernels.sitestats import site_stats, freq_min_count_lut
from .filter_reads import PairSet


@dataclass
class ScaffoldPileup:
    """Dense pileup inputs for one scaffold."""

    name: str
    rid: int
    length: int
    mm_values: np.ndarray          # int64 [M] sorted distinct pair mms
    counts: np.ndarray             # int32 [M, 4, L] exact-mm base counts
    # event source for linkage capture (lazy; native-backed)
    bam: Optional[BamArrays] = None
    qid2mmidx: Optional[np.ndarray] = None  # int32 per qname -> mm index
    # set when counts is already bucket-padded ([Mp, 4, Lp] int16 from the
    # native padded builder); holds the true mm-level count M. `length`
    # stays the true L. None => counts carries true shapes.
    true_M: Optional[int] = None

    def select_events(self, pos_mask: np.ndarray):
        """(pos, base, mm_idx, qname) of counted bases at masked positions
        — extracted natively from the decoder's event buffers."""
        assert self.bam is not None and self.qid2mmidx is not None
        return self.bam.select_events(self.rid, self.qid2mmidx, pos_mask)

    @property
    def counts_exact(self) -> np.ndarray:
        """True-shaped [M, 4, L] view of counts (strips bucket padding)."""
        if self.true_M is None:
            return self.counts
        return self.counts[:self.true_M, :, :self.length]


def build_scaffold_pileup(bam: BamArrays, pairs: PairSet, rid: int,
                          length: int) -> Optional[ScaffoldPileup]:
    """
    Scatter counted base events (qual >= 30, ACTG, reads whose pair passed
    filtering) into the dense count tensor — a single native pass over the
    decoder's event buffers (bd_build_counts).

    pysam-parity notes (see io/bam.py): with the reference's stepper
    ('nofilter') orphans are NOT excluded from the pileup, and base
    qualities have already been mate-overlap tweaked during decode.
    """
    qids, mms = pairs.r2m_for_scaffold(rid)
    if len(qids) == 0:
        return None
    mm_values = np.unique(mms)
    mm_to_idx = {int(m): i for i, m in enumerate(mm_values)}
    n_q = bam.n_qnames or int(bam.qname_id.max()) + 1
    qid2mmidx = np.full(n_q, -1, dtype=np.int32)
    qid2mmidx[qids] = np.array([mm_to_idx[int(m)] for m in mms],
                               dtype=np.int32)

    counts = bam.build_counts(rid, qid2mmidx, len(mm_values), length)
    if counts.sum() == 0:
        return None

    # drop mm levels with no counted bases anywhere (a pair whose bases
    # were all quality-masked contributes no level, matching the
    # reference's covT key semantics)
    level_mask = counts.sum(axis=(1, 2)) > 0
    if not level_mask.all():
        keep_idx = np.nonzero(level_mask)[0]
        remap = np.full(len(mm_values), -1, dtype=np.int32)
        remap[keep_idx] = np.arange(len(keep_idx), dtype=np.int32)
        qid2mmidx = np.where(qid2mmidx >= 0, remap[qid2mmidx], -1).astype(
            np.int32)
        counts = counts[level_mask]
        mm_values = mm_values[level_mask]

    return ScaffoldPileup(name=bam.ref_names[rid], rid=rid, length=length,
                          mm_values=mm_values, counts=counts,
                          bam=bam, qid2mmidx=qid2mmidx)


def build_scaffold_pileup_padded(bam: BamArrays, pairs: PairSet, rid: int,
                                 length: int, m_step: int = 8,
                                 l_step: int = 4096
                                 ) -> Optional[ScaffoldPileup]:
    """
    build_scaffold_pileup via the native padded int16 scatter: counts come
    out already bucket-padded ([Mp, 4, Lp], mm axis to multiples of
    `m_step`, positions to `l_step`) and transfer-ready — no host padding
    copy, half the bytes across the host->device link. Falls back to the
    int32 builder if a cell exceeds int16 (exact-mm coverage > 32767).
    """
    qids, mms = pairs.r2m_for_scaffold(rid)
    if len(qids) == 0:
        return None
    mm_values = np.unique(mms)
    n_mm = len(mm_values)
    mm_to_idx = {int(m): i for i, m in enumerate(mm_values)}
    n_q = bam.n_qnames or int(bam.qname_id.max()) + 1
    qid2mmidx = np.full(n_q, -1, dtype=np.int32)
    qid2mmidx[qids] = np.array([mm_to_idx[int(m)] for m in mms],
                               dtype=np.int32)

    Mp_alloc = max(_bucket(n_mm, m_step), m_step)
    Lp = max(_bucket(length, l_step), l_step)
    res = bam.build_counts_padded(rid, qid2mmidx, n_mm, length, Lp,
                                  Mp_alloc)
    if res is None:                       # int16 overflow: rare, fall back
        return build_scaffold_pileup(bam, pairs, rid, length)
    counts, level_events, level_map = res
    kept = int((level_events > 0).sum())
    if kept == 0:
        return None
    if kept < n_mm:
        qid2mmidx = np.where(qid2mmidx >= 0, level_map[qid2mmidx],
                             -1).astype(np.int32)
        mm_values = mm_values[level_events > 0]
    Mp = max(_bucket(kept, m_step), m_step)
    return ScaffoldPileup(name=bam.ref_names[rid], rid=rid, length=length,
                          mm_values=mm_values, counts=counts[:Mp],
                          bam=bam, qid2mmidx=qid2mmidx, true_M=kept)


@dataclass
class ScaffoldStats:
    """site_stats outputs materialized to host numpy (see sitestats.py)."""

    pileup: ScaffoldPileup
    arrays: Dict[str, np.ndarray]

    def __getattr__(self, name):
        try:
            return self.arrays[name]
        except KeyError:
            raise AttributeError(name)

    @property
    def mm_values(self):
        return self.pileup.mm_values


def _bucket(n: int, step: int) -> int:
    return -(-n // step) * step


def run_site_stats(pileup: ScaffoldPileup, ref_codes: np.ndarray,
                   null_lut: np.ndarray, freq_lut: np.ndarray,
                   min_cov: int = 5, rarefied_coverage: int = 50,
                   seed: int = 42, pad_shapes: bool = True,
                   max_chunk: int = 1 << 20) -> ScaffoldStats:
    """
    Run the site-stats kernel for one scaffold.

    Shapes are bucketed (mm axis to multiples of 8, position axis to
    multiples of 4096) so scaffolds share compiled kernels; padding
    cells carry zero counts / ref code 4 and are masked naturally, and all
    outputs are sliced back to true dimensions.

    Every output is position-local, so scaffolds longer than `max_chunk`
    are processed in position chunks and concatenated on host — one
    multi-Mb isolate genome never has to fit the [M, 4, L] working set in
    device memory at once (the reference bounds this the same way with
    its 10 kb windows, profile_utilities.py:115-216).
    """
    counts = pileup.counts_exact
    M, _, L = counts.shape
    if L > max_chunk:
        parts = []
        for c0 in range(0, L, max_chunk):
            c1 = min(c0 + max_chunk, L)
            sub = ScaffoldPileup.__new__(ScaffoldPileup)
            sub.__dict__.update(pileup.__dict__)
            sub.true_M = None
            sub.counts = np.ascontiguousarray(counts[:, :, c0:c1])
            # decorrelate the rarefied-subsample draws per chunk
            parts.append(run_site_stats(
                sub, np.ascontiguousarray(ref_codes[c0:c1]), null_lut,
                freq_lut, min_cov=min_cov,
                rarefied_coverage=rarefied_coverage,
                seed=seed + 7919 * (c0 // max_chunk),
                pad_shapes=pad_shapes, max_chunk=L))
        arrays = {k: np.concatenate([p.arrays[k] for p in parts], axis=-1)
                  for k in parts[0].arrays}
        return ScaffoldStats(pileup=pileup, arrays=arrays)
    if pad_shapes:
        Mp, Lp = max(_bucket(M, 8), 8), max(_bucket(L, 4096), 4096)
        if (Mp, Lp) != (M, L):
            cp = np.zeros((Mp, 4, Lp), counts.dtype)
            cp[:M, :, :L] = counts
            rp = np.full(Lp, 4, dtype=ref_codes.dtype)
            rp[:L] = ref_codes
            counts, ref_codes = cp, rp
    # host-computed threefry key, bit-identical to device fold_in
    # (compact._fold_keys; saves a device dispatch per scaffold)
    from .compact import _fold_keys
    key = _fold_keys(seed, [pileup.rid])[0]
    out = site_stats(counts, ref_codes, null_lut, freq_lut, key,
                     min_cov=min_cov, min_covR=rarefied_coverage,
                     rarefied_draws=rarefied_coverage)
    arrays = {}
    for k, v in out.items():
        v = np.asarray(v)
        if k == "bases_mask":                    # [4, L]
            v = v[:, :L]
        elif v.ndim == 3:                        # [M, 4, L]
            v = v[:M, :, :L]
        elif v.ndim == 2:                        # [M, L]
            v = v[:M, :L]
        elif v.ndim == 1:                        # [L]
            v = v[:L]
        arrays[k] = v
    return ScaffoldStats(pileup=pileup, arrays=arrays)


def make_luts(cfg_variant) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve (null threshold LUT, min-freq LUT) from a VariantConfig."""
    null_lut = nullmodel.null_thresholds(
        cfg_variant.null_model, fdr=cfg_variant.fdr,
        error_rate=cfg_variant.null_model_error_rate,
        max_coverage=cfg_variant.null_model_max_coverage)
    freq_lut = freq_min_count_lut(
        cfg_variant.min_freq,
        max_coverage=cfg_variant.null_model_max_coverage)
    return null_lut, freq_lut
