"""
The `compare` operation: profile-vs-profile popANI/conANI
(reference: inStrain/compare_controller.py + readComparer.py +
compare_utils.py).

Per scaffold and profile pair, per mm level (union of both profiles'
levels, cumulative): positions covered >= min_cov in both samples form the
overlap; consensus SNPs = positions where the consensus bases differ;
population SNPs additionally require that neither sample's consensus is
detectable above the null model in the other and that no minor allele is
shared. conANI = (overlap - conSNPs)/overlap, popANI likewise.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..config import CompareConfig
from ..kernels.nullmodel import null_thresholds
from ..kernels.sitestats import freq_min_count_lut
from ..obs.logging import log_checkpoint, log_failure
from ..store import generate as gen
from ..store.profile_dir import ProfileDir

BASE_IDX = {"A": 0, "C": 1, "T": 2, "G": 3}


@dataclass
class SampleScaffoldData:
    """Per (profile, scaffold) cached comparison inputs."""

    covT: Dict[int, pd.Series]
    snp: pd.DataFrame        # deduped (highest-mm) rows, position-indexed


@dataclass
class ScaffoldComparison:
    scaffold: str
    length: int
    names: List[str] = field(default_factory=list)
    profiles: List[ProfileDir] = field(default_factory=list)

    def valid(self) -> bool:
        assert len(self.names) == len(set(self.names)), \
            "profiles with the same name cannot be compared"
        return len(self.profiles) > 1


def compare(inputs: List[str], cfg: CompareConfig,
            output: Optional[str] = None) -> ProfileDir:
    """Run the full compare operation."""
    out = ProfileDir(output or cfg.output)
    null_lut = null_thresholds(cfg.null_model, fdr=cfg.fdr)
    freq_lut = freq_min_count_lut(cfg.min_freq)

    assert len(inputs) > 1, "need more than one input profile"
    profiles = [ProfileDir(p) for p in inputs]
    names = [os.path.basename(str(p.get("bam_loc"))) for p in profiles]

    # scaffold selection (reference: compare_controller.py:104-148,611-658)
    scaffolds_to_compare = None
    stb = None
    if cfg.scaffolds is not None:
        from ..io.fasta import load_scaff_list
        scaffolds_to_compare = load_scaff_list(cfg.scaffolds)
    if cfg.stb:
        from ..io.stb import load_scaff2bin
        stb = load_scaff2bin(cfg.stb)
        scaffolds_to_compare = ((scaffolds_to_compare or set()) |
                                set(stb.keys()))
    input2scaffolds = None
    if (cfg.database_mode or cfg.genome is not None) and stb is None:
        # a clear error instead of AttributeError deep in the stb walk
        raise ValueError(
            "--database_mode and --genome require a scaffold-to-bin "
            "file (-s/--stb)")
    if cfg.database_mode:
        input2scaffolds = {}
        bin2scaffolds = defaultdict(list)
        for s, b in stb.items():
            bin2scaffolds[b].append(s)
        for path, prof in zip(inputs, profiles):
            input2scaffolds[path] = find_relevant_scaffolds(
                prof, bin2scaffolds, cfg.breadth)
    if cfg.genome is not None:
        bin2scaffolds = defaultdict(set)
        for s, b in stb.items():
            bin2scaffolds[b].add(s)
        if cfg.genome not in bin2scaffolds:
            raise ValueError(f"genome {cfg.genome} is not in the stb")
        scaffolds_to_compare = ((scaffolds_to_compare or
                                 set(stb.keys())) &
                                bin2scaffolds[cfg.genome])

    SCs, s2l = make_comparison_objects(inputs, profiles, names,
                                       scaffolds_to_compare,
                                       input2scaffolds)

    # run comparisons in ~group_length batches (reference:
    # compare_controller.py:594-609 bounds RAM per group)
    log_checkpoint("Compare", "multiprocessing", "start")
    cdbs, mdbs = [], []
    scaff2pair2mm2overlap = {} if cfg.store_coverage_overlap else None
    if not cfg.skip_popANI:
        group, group_len = [], 0
        groups = []
        for sc in SCs:
            group.append(sc)
            group_len += sc.length
            if group_len >= cfg.group_length:
                groups.append(group)
                group, group_len = [], 0
        if group:
            groups.append(group)
        from ..obs.logging import progress
        for gi, grp in enumerate(groups):
            logging.info(f"Running group {gi + 1} of {len(groups)}")
            _preload_group_covt(grp)
            for sc in progress(grp, desc="Comparing scaffolds"):
                try:
                    cdb, mdb, p2o = compare_scaffold(sc, null_lut,
                                                     freq_lut, cfg)
                    cdbs.append(cdb)
                    if mdb is not None:
                        mdbs.append(mdb)
                    if scaff2pair2mm2overlap is not None and p2o:
                        scaff2pair2mm2overlap[sc.scaffold] = p2o
                except Exception as e:
                    # 'CompareException' is the failure class the run
                    # report grammar knows (obs/logging.py _FAILURE_TEXT;
                    # reference logUtils.py:707-767)
                    log_failure("CompareException", sc.scaffold, str(e))
            _SNP_CACHE.clear()  # purge per-group caches
            _COVT_CACHE.clear()
    log_checkpoint("Compare", "multiprocessing", "end")

    comparison_db = (pd.concat(cdbs, sort=False).reset_index(drop=True)
                     if cdbs else pd.DataFrame())
    mismatch_db = (pd.concat(mdbs, sort=False).reset_index(drop=True)
                   if mdbs else None)
    if mismatch_db is not None and len(mismatch_db):
        for c in ("position", "mm"):
            mismatch_db[c] = mismatch_db[c].astype(int)
        for c in ("consensus_SNP", "population_SNP"):
            mismatch_db[c] = mismatch_db[c].astype(bool)

    # store
    if not cfg.skip_popANI:
        out.store("comparisonsTable", comparison_db, "pandas",
                  "Comparisons between the requested IS objects")
    out.store("scaffold2length", {sc.scaffold: sc.length for sc in SCs},
              "dictionary", "Scaffold to length")

    # genome-level + clustering
    genomelevel = None
    if stb is not None and not cfg.skip_popANI and len(comparison_db):
        b2l: Dict[str, int] = {}
        s2l_local = {sc.scaffold: sc.length for sc in SCs}
        for scaffold, b in stb.items():
            b2l.setdefault(b, 0)
            if scaffold in s2l_local:
                b2l[b] += s2l_local[scaffold]
        out.store("bin2length", b2l, "dictionary",
                  "Dictionary of bin 2 total length")
        out.store("scaffold2bin", stb, "dictionary",
                  "Dictionary of scaffold 2 bin")
        from ..profile.genome import genome_wide_readcomparer, _add_stb
        gdb = _add_stb(comparison_db, stb)
        genomelevel = genome_wide_readcomparer(gdb, stb, b2l)
        genomelevel.to_csv(out.get_output_base() + "genomeWide_compare.tsv",
                           index=False, sep="\t")
        try:
            from .clustering import cluster_genome_strains
            cdb = cluster_genome_strains(
                genomelevel.sort_values(["genome", "name1", "name2"]), cfg)
            if cdb is not None and len(cdb):
                cdb.to_csv(out.get_output_base() + "strain_clusters.tsv",
                           index=False, sep="\t")
        except Exception:
            logging.exception("Could not cluster genomes")

    # pooling
    if cfg.bams:
        from .pooling import run_pooling
        if len(cfg.bams) != len(names):
            raise ValueError(
                f"-b/--bams got {len(cfg.bams)} BAMs for {len(names)} "
                f"input profiles; they must pair up 1:1 in order")
        name2bam = dict(zip(names, cfg.bams))
        dst, pmdb = run_pooling(SCs, name2bam, null_lut, freq_lut)
        out.store("DSTdb", dst, "pickle", "Dense SNV table (from pooling)")
        out.store("PMdb", pmdb, "pickle",
                  "Informative SNV table (from pooling)")
        gen.generate(out, "pooled_SNV_info")
        gen.generate(out, "pooled_SNV_data")

    if not cfg.skip_popANI:
        gen.generate(out, "comparisonsTable",
                     force_compress=cfg.force_compress)
    if cfg.store_mismatch_locations and mismatch_db is not None:
        out.store("pairwise_SNP_locations", mismatch_db, "pandas",
                  "A dataframe of scaffold, IS pair, mm, SNP locations")
        gen.generate(out, "pairwise_SNP_locations")
    if scaff2pair2mm2overlap:
        # reference: compare_controller.py:377-379
        out.store("scaff2pair2mm2cov", scaff2pair2mm2overlap, "special",
                  "A dictionary of scaffold -> IS pair -> mm level -> "
                  "positions with coverage overlap")

    if genomelevel is not None and not cfg.skip_plot_generation:
        try:
            from ..plotting.controller import make_plots
            make_plots(out, plots=["10"])
        except Exception:
            logging.exception("compare plotting failed")
    return out


def find_relevant_scaffolds(prof: ProfileDir, bin2scaffolds,
                            min_breadth: float):
    """database mode (reference: compare_utils.find_relevant_scaffolds)."""
    gidb = prof.get("genome_level_info")
    if gidb is None:
        raise ValueError("profile lacks genome_level_info "
                         "(needed for database mode)")
    if "mm" in gidb:
        gidb = (gidb.sort_values("mm")
                    .drop_duplicates(subset=["genome"], keep="last"))
    genomes = gidb[gidb["breadth_minCov"] >= min_breadth]["genome"].tolist()
    scaffolds = []
    for genome in genomes:
        if genome not in bin2scaffolds:
            raise ValueError(f"{genome} not in the provided stb")
        scaffolds += bin2scaffolds[genome]
    return set(scaffolds)


def make_comparison_objects(inputs, profiles, names, scaffolds_to_compare,
                            input2scaffolds):
    scaffold2SC: Dict[str, ScaffoldComparison] = {}
    scaffold2length: Dict[str, int] = {}
    for path, prof, name in zip(inputs, profiles, names):
        scaffolds = prof.covt_scaffolds()
        if input2scaffolds is not None:
            scaffolds &= input2scaffolds[path]
        if scaffolds_to_compare is not None:
            scaffolds &= set(scaffolds_to_compare)
        s2l = prof.get("scaffold2length")
        for s, l in s2l.items():
            if s in scaffold2length:
                assert int(l) == scaffold2length[s], s
            scaffold2length[s] = int(l)
        for s in scaffolds:
            sc = scaffold2SC.setdefault(
                s, ScaffoldComparison(s, scaffold2length[s]))
            sc.names.append(name)
            sc.profiles.append(prof)
    valid = [sc for sc in scaffold2SC.values() if sc.valid()]
    logging.info(f"{len(valid)} of {len(scaffold2SC)} scaffolds are in at "
                 "least 2 samples")
    assert valid, "No scaffolds are shared among the profiles"
    return valid, scaffold2length


_SNP_CACHE: Dict[str, Dict[str, pd.DataFrame]] = {}
# per-group covT bulk cache: profile location -> scaffold -> mm -> Series
_COVT_CACHE: Dict[str, Dict] = {}


def _preload_group_covt(grp):
    """Bulk-load each profile's covT for a comparison group in ONE hd5
    pass per profile (reference: SCgroup.load_cache,
    compare_controller.py:520-585). The former per-(profile, scaffold)
    prof.get('covT', scaffolds=[s]) opened the file and scanned every
    dataset key once per scaffold — O(n_scaffolds * n_samples) opens and
    O(total_keys) scans each, quadratic at metagenome scale. Purged with
    the group (bounds RAM like the reference's cache purge)."""
    want: Dict[str, set] = {}
    profs = {}
    for sc in grp:
        for prof in sc.profiles:
            want.setdefault(prof.location, set()).add(sc.scaffold)
            profs[prof.location] = prof
    for loc, scaffolds in want.items():
        cached = _COVT_CACHE.setdefault(loc, {})
        missing = [s for s in scaffolds if s not in cached]
        if missing:
            cached.update(profs[loc].get("covT", scaffolds=missing)
                          or {})


def _load_scaffold_data(prof: ProfileDir, scaffold: str
                        ) -> SampleScaffoldData:
    cache = _COVT_CACHE.get(prof.location)
    if cache is not None and scaffold in cache:
        covT = cache[scaffold]
    else:
        covT = prof.get("covT", scaffolds=[scaffold]).get(scaffold, {})
    key = prof.location
    if key not in _SNP_CACHE:
        _SNP_CACHE[key] = snvs_by_scaffold(prof.get("cumulative_snv_table"))
    snp = _SNP_CACHE[key].get(scaffold, pd.DataFrame())
    return SampleScaffoldData(covT=covT, snp=snp)


def snvs_by_scaffold(db: Optional[pd.DataFrame]) -> Dict[str, pd.DataFrame]:
    """A profile's cumulative_snv_table, split per scaffold and sorted by
    mm, with the column names the comparison reads."""
    if db is None or not len(db):
        return {}
    db = db.rename(columns={
        "conBase": "con_base", "refBase": "ref_base",
        "varBase": "var_base", "baseCoverage": "position_coverage"})
    db = db.sort_values(["scaffold", "mm"])
    return {s: d for s, d in db.groupby("scaffold")}


def _threshold_masks(covT: Dict[int, pd.Series], mms_global, L: int,
                     min_cov: int) -> np.ndarray:
    """Per-mm cumulative coverage-threshold masks [Mg, L] bool at the
    scaffold's GLOBAL mm grid. Computed ONCE per sample — the former
    per-pair accumulation redid this O(n_samples) times per sample
    (reference semantics: readComparer.calc_mm2overlap 145-191; the
    cumulative coverage at mm m depends only on levels <= m, so the
    global grid restricted to a pair's union equals the pair-local
    computation)."""
    t = np.zeros((len(mms_global), L), dtype=bool)
    cov = np.zeros(L)
    for k, mm in enumerate(mms_global):
        s = covT.get(mm)
        if s is not None:
            cov[s.index.values] += s.values
        t[k] = cov >= min_cov
    return t


def _use_device_overlap(cfg, n: int, mg: int, L: int) -> bool:
    eng = getattr(cfg, "engine", "auto")
    if eng == "host":
        return False
    if eng == "device":
        return True
    import jax
    if jax.default_backend() == "cpu":
        return False
    # a device launch pays off only when the popcount work is
    # substantial (all-pairs AND over n^2/2 * Mg * L bits)
    return n * n * mg * L >= 1 << 33


def compare_scaffold(sc: ScaffoldComparison, null_lut, freq_lut,
                     cfg: CompareConfig,
                     datas: Optional[List[SampleScaffoldData]] = None):
    """reference: readComparer.compare_scaffold (35-143). `datas`, one
    per name in `sc.names`, stands in for loading each sample's covT and
    SNVs from `sc.profiles`."""
    if datas is None:
        datas = [_load_scaffold_data(p, sc.scaffold) for p in sc.profiles]
    table = defaultdict(list)
    mdbs = []
    pair2mm2overlap = {}
    n = len(sc.names)

    # per-sample threshold masks at the global mm grid + all-pairs
    # overlap counts (bf16 einsum on device, u64 popcount on host —
    # bit-identical; kernels/compare.py)
    mms_global = sorted({mm for d in datas for mm in d.covT})
    masks = [_threshold_masks(d.covT, mms_global, sc.length, cfg.min_cov)
             for d in datas]
    from ..kernels import compare as kcompare
    if _use_device_overlap(cfg, n, max(len(mms_global), 1), sc.length):
        both_counts, single_counts = \
            kcompare.pairwise_overlap_counts_device(masks)
    else:
        both_counts, single_counts = \
            kcompare.pairwise_overlap_counts_host(masks)
    pre = dict(mms_global=mms_global, masks=masks,
               both=both_counts, single=single_counts)

    for i in range(n):
        for j in range(i, n):
            if i == j and not cfg.include_self_comparisons:
                continue
            rows, mdb, mm2ov = _compare_pair(
                sc, datas[i], datas[j], sc.names[i], sc.names[j],
                null_lut, freq_lut, cfg, pre, i, j)
            for k, v in rows.items():
                table[k].extend(v)
            if cfg.store_mismatch_locations and mdb is not None:
                mdbs.append(mdb)
            if mm2ov is not None:
                key = "-vs-".join(sorted([sc.names[i], sc.names[j]]))
                pair2mm2overlap[key] = mm2ov
    cdb = pd.DataFrame(table)
    mdb = pd.concat(mdbs, sort=False) if mdbs else None
    return cdb, mdb, pair2mm2overlap


def _dedupe_snp(snp: pd.DataFrame) -> pd.DataFrame:
    """Highest-mm row per position (the tables are pre-sorted by mm)."""
    if len(snp) == 0:
        return snp
    return snp.drop_duplicates(subset=["position"], keep="last")


def _compare_pair(sc, d1, d2, name1, name2, null_lut, freq_lut, cfg,
                  pre, i, j):
    """One sample pair's rows from the precomputed per-sample masks and
    all-pairs overlap counts (`pre`, built in compare_scaffold).
    reference: readComparer.py:145-191 + 205-289."""
    L = sc.length
    mms = sorted(set(d1.covT.keys()) | set(d2.covT.keys()))
    gidx = [pre["mms_global"].index(mm) for mm in mms]
    t1g, t2g = pre["masks"][i], pre["masks"][j]
    bothc = pre["both"][:, i, j]
    c1, c2 = pre["single"][:, i], pre["single"][:, j]
    cov_overlap = np.zeros(len(mms))
    bases_k = np.zeros(len(mms), dtype=np.int64)
    for k, g in enumerate(gidx):
        e = c1[g] + c2[g] - bothc[g]
        bases_k[k] = bothc[g]
        cov_overlap[k] = (bothc[g] / e) if e > 0 else 0

    # SNP-position-level calls (mm-independent; reference merges the
    # highest-mm rows of each sample, readComparer.py:229-289)
    s1 = _dedupe_snp(d1.snp)
    s2 = _dedupe_snp(d2.snp)
    pos_union = np.union1d(
        s1["position"].values if len(s1) else np.zeros(0, int),
        s2["position"].values if len(s2) else np.zeros(0, int)).astype(int)

    if len(pos_union):
        con_snp, pop_snp, pairinfo = _call_pair_snps(
            s1, s2, pos_union, null_lut, freq_lut, cfg.min_freq)
        active_g = t1g[:, pos_union] & t2g[:, pos_union]   # [Mg, P]
    else:
        con_snp = np.zeros(0, dtype=bool)
        pop_snp = np.zeros(0, dtype=bool)
        pairinfo = None
        active_g = np.zeros((len(pre["mms_global"]), 0), dtype=bool)

    rows = defaultdict(list)
    mdb_rows = []
    for k, (mm, g) in enumerate(zip(mms, gidx)):
        active = active_g[g]
        snps = int((con_snp & active).sum())
        popsnps = int((pop_snp & active).sum())
        bases = int(bases_k[k])
        rows["mm"].append(mm)
        rows["scaffold"].append(sc.scaffold)
        rows["name1"].append(name1)
        rows["name2"].append(name2)
        rows["coverage_overlap"].append(cov_overlap[k])
        rows["compared_bases_count"].append(bases)
        rows["percent_genome_compared"].append(bases / L)
        rows["length"].append(L)
        rows["consensus_SNPs"].append(snps)
        rows["population_SNPs"].append(popsnps)
        if bases == 0:
            rows["conANI"].append(np.nan)
            rows["popANI"].append(np.nan)
        else:
            rows["conANI"].append((bases - snps) / bases)
            rows["popANI"].append((bases - popsnps) / bases)
        if cfg.store_mismatch_locations and pairinfo is not None:
            sel = active & (con_snp | pop_snp)
            if sel.any():
                mrows = pairinfo[sel].copy()
                mrows["mm"] = mm
                mrows["consensus_SNP"] = con_snp[sel]
                mrows["population_SNP"] = pop_snp[sel]
                mrows["name1"] = name1
                mrows["name2"] = name2
                mrows["scaffold"] = sc.scaffold
                mdb_rows.append(mrows)
    mdb = pd.concat(mdb_rows, sort=False) if mdb_rows else None
    # positions covered >= min_cov in both samples, per mm
    # (reference: readComparer.py:118-119 via calc_mm2overlap)
    mm2ov = ({mm: np.flatnonzero(t1g[g] & t2g[g])
              for mm, g in zip(mms, gidx)}
             if cfg.store_coverage_overlap else None)
    return rows, mdb, mm2ov


def _call_pair_snps(s1, s2, pos_union, null_lut, freq_lut, min_freq):
    """Vectorized call_con_snps / call_pop_snps
    (reference: readComparer.py:291-376)."""
    P = len(pos_union)

    def extract(s):
        has = np.zeros(P, dtype=bool)
        con = np.full(P, "", dtype=object)
        ref = np.full(P, "", dtype=object)
        var = np.full(P, "", dtype=object)
        counts = np.zeros((P, 4), dtype=np.int64)
        covg = np.zeros(P, dtype=np.int64)
        ac = np.zeros(P, dtype=np.int64)
        if len(s):
            idx = np.searchsorted(pos_union, s["position"].values)
            has[idx] = True
            con[idx] = s["con_base"].values
            ref[idx] = s["ref_base"].values
            var[idx] = s["var_base"].values
            for b, bi in BASE_IDX.items():
                counts[idx, bi] = s[b].values
            covg[idx] = s["position_coverage"].values
            if "allele_count" in s:
                ac[idx] = s["allele_count"].values
            elif "morphia" in s:
                ac[idx] = s["morphia"].values
        return has, con, ref, var, counts, covg, ac

    h1, con1, ref1, var1, c1, t1, a1 = extract(s1)
    h2, con2, ref2, var2, c2, t2, a2 = extract(s2)

    def is_present(counts, covg, base_arr):
        maxcov = len(null_lut) - 1
        cc = np.minimum(covg, maxcov)
        min_bases = null_lut[cc]
        fmin = freq_lut[cc]
        bcount = np.zeros(P, dtype=np.int64)
        for b, bi in BASE_IDX.items():
            m = base_arr == b
            bcount[m] = counts[m, bi]
        return (bcount >= min_bases) & (bcount >= fmin) & (covg > 0)

    # consensus SNPs
    con_snp = np.where(
        ~h1, con2 != ref2,
        np.where(~h2, con1 != ref1, con1 != con2))

    # population SNPs
    pop = np.ones(P, dtype=bool)
    same_con = h1 & h2 & (con1 == con2)
    pop[same_con] = False
    pop[~h1 & ~h2] = False

    only2 = ~h1 & h2
    pop[only2 & is_present(c2, t2, ref2)] = False
    only1 = h1 & ~h2
    pop[only1 & is_present(c1, t1, ref1)] = False

    in_both = h1 & h2 & (con1 != con2)
    pop[in_both & is_present(c2, t2, con1)] = False
    pop[in_both & is_present(c1, t1, con2)] = False
    shared_minor = in_both & (a1 > 1) & (a2 > 1) & (var1 == var2)
    pop[shared_minor] = False

    pairinfo = pd.DataFrame({
        "position": pos_union,
        "con_base_1": np.where(h1, con1, np.nan),
        "ref_base_1": np.where(h1, ref1, np.nan),
        "var_base_1": np.where(h1, var1, np.nan),
        "position_coverage_1": np.where(h1, t1, np.nan),
        "A_1": np.where(h1, c1[:, 0], np.nan),
        "C_1": np.where(h1, c1[:, 1], np.nan),
        "T_1": np.where(h1, c1[:, 2], np.nan),
        "G_1": np.where(h1, c1[:, 3], np.nan),
        "con_base_2": np.where(h2, con2, np.nan),
        "ref_base_2": np.where(h2, ref2, np.nan),
        "var_base_2": np.where(h2, var2, np.nan),
        "position_coverage_2": np.where(h2, t2, np.nan),
        "A_2": np.where(h2, c2[:, 0], np.nan),
        "C_2": np.where(h2, c2[:, 1], np.nan),
        "T_2": np.where(h2, c2[:, 2], np.nan),
        "G_2": np.where(h2, c2[:, 3], np.nan),
    })
    return con_snp.astype(bool), pop.astype(bool), pairinfo
