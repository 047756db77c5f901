"""
Sequencing-error null model for SNV calling.

The reference ships a bootstrap-simulated table (inStrain
helper_files/NullModel.txt, generated by helper_scripts/calculate_null.py:
for each coverage N, simulate N draws with error probability p=0.001 split
over 3 error bases, and tabulate P(an error base reaches count >= e)).
At profile time the table becomes `model[coverage] -> min alternate-base
count to call a variant` via the first column with probability < fdr
(reference: profile/snv_utilities.py:14-38; note the 0-based `i` there,
which we reproduce: threshold = first_column_below_fdr - 1... i.e. the
index i such that column i+1 is the first below fdr).

Here the default model is *analytic*: the bootstrap estimates
3 * P(Binom(N, p/3) >= e), which we compute exactly with a stable survival
recurrence — deterministic, no simulation noise. A handful of coverages sit
at the fdr knife edge where one noisy bootstrap draw differs from the exact
value; for bit-parity against a specific inStrain table, load it with
`load_null_model_file`.

The model is materialized as a dense int32 LUT `thresholds[coverage]`
(coverage 0..max_coverage; out-of-range coverage uses the max threshold,
matching model[-1] = max(model.values()) in the reference), which maps
directly onto device gather lookups.
"""

from __future__ import annotations

import numpy as np

_CACHE = {}


def analytic_null_thresholds(max_coverage: int = 10000, fdr: float = 1e-6,
                             error_rate: float = 0.001,
                             max_columns: int = 18) -> np.ndarray:
    """
    Exact-binomial equivalent of generate_snp_model(NullModel.txt, fdr).

    Returns int32 array `thr` of length max_coverage + 1 where
    thr[cov] = minimum count of an alternate base to exceed the fdr at
    that coverage. thr[0] is unused (coverage 0 is never counted).

    The reference table has `max_columns` probability columns
    (error-base count e = 1..18); if no column is below fdr the coverage is
    absent from the model and falls back to the max threshold — reproduced
    here by assigning max_columns - 1 and then maxing (for p=0.001 and
    fdr >= 1e-12 this never triggers below cov=10000).
    """
    key = (max_coverage, fdr, error_rate, max_columns)
    if key in _CACHE:
        return _CACHE[key]

    p = error_rate / 3.0
    covs = np.arange(0, max_coverage + 1, dtype=np.float64)

    # P(X = 0) = (1-p)^N
    log1mp = np.log1p(-p)
    logpmf = covs * log1mp  # log P(X=0) per coverage
    surv = np.ones(max_coverage + 1)  # P(X >= 0) = 1
    thr = np.full(max_coverage + 1, max_columns - 1, dtype=np.int32)
    remaining = np.ones(max_coverage + 1, dtype=bool)

    pmf = np.exp(logpmf)  # P(X = e-1), starting with e-1 = 0
    for e in range(1, max_columns + 1):
        # P(X >= e) = P(X >= e-1) - P(X = e-1)
        surv = np.maximum(surv - pmf, 0.0)
        prob = 3.0 * surv
        hit = remaining & (prob < fdr)
        # reference's 0-based counter: model[cov] = i where column (i+1)
        # is the first with probability < fdr  =>  threshold = e - 1
        thr[hit] = e - 1
        remaining &= ~hit
        if not remaining.any():
            break
        # pmf step: P(X = e) = P(X = e-1) * (N - e + 1)/e * p/(1-p)
        with np.errstate(invalid="ignore"):
            pmf = pmf * np.maximum(covs - (e - 1), 0.0) / e * (p / (1.0 - p))

    thr[0] = thr[1] if max_coverage >= 1 else 0
    _CACHE[key] = thr
    return thr


def load_null_model_file(path: str, fdr: float = 1e-6,
                         max_coverage: int = 10000) -> np.ndarray:
    """
    Parse an inStrain-format NullModel.txt into the dense threshold LUT.

    File format (helper_scripts/calculate_null.py output): TSV with header
    `coverage  1  2 ... 18`; each row gives P(error-base count >= e) for
    e = 1..18 at that coverage.
    """
    thr = np.full(max_coverage + 1, -1, dtype=np.int32)
    seen_max = 0
    with open(path) as f:
        for line in f:
            if "coverage" in line:
                continue
            parts = line.split()
            cov = int(parts[0])
            if cov > max_coverage:
                continue
            for i, val in enumerate(parts[1:]):
                if float(val) < fdr:
                    thr[cov] = i
                    break
            seen_max = max(seen_max, cov)
    fallback = thr[thr >= 0].max() if (thr >= 0).any() else 0
    thr[thr < 0] = fallback
    thr[0] = thr[1]
    return thr


def null_thresholds(cfg_null_model: str = "analytic", fdr: float = 1e-6,
                    error_rate: float = 0.001,
                    max_coverage: int = 10000) -> np.ndarray:
    """Resolve a VariantConfig null model spec to a dense LUT."""
    if cfg_null_model == "analytic":
        return analytic_null_thresholds(max_coverage=max_coverage, fdr=fdr,
                                        error_rate=error_rate)
    return load_null_model_file(cfg_null_model, fdr=fdr,
                                max_coverage=max_coverage)


def lookup(thr: np.ndarray, coverage):
    """min alternate-base count at `coverage`; clamps like model[-1]."""
    coverage = np.minimum(coverage, len(thr) - 1)
    return thr[coverage]
