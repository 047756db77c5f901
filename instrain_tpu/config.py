"""
Typed configuration for instrain_tpu.

Single source of truth for every default, mirroring the reference CLI
defaults (reference: inStrain/argumentParser.py:55-398). The reference
duplicates defaults in kwargs.get() calls at use sites with some drift
(e.g. min_snp 10 vs 20, profile_utilities.py:145 vs argumentParser.py:164);
here the CLI-facing defaults win and are defined exactly once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ReadFilterConfig:
    """Read-pair filtering (reference: argumentParser.py:74-95)."""

    min_read_ani: float = 0.95        # PID must be > this (strictly)
    min_mapq: int = -1                # pair max mapq must be > this
    max_insert_relative: float = 3.0  # max insert = this * median insert
    min_insert: int = 50              # insert must be > this
    pairing_filter: str = "paired_only"  # paired_only|non_discordant|all_reads
    priority_reads: Optional[str] = None
    maximum_reads: Optional[int] = None


@dataclass
class VariantConfig:
    """SNV calling (reference: argumentParser.py:104-112)."""

    min_cov: int = 5
    min_freq: float = 0.05
    fdr: float = 1e-6
    # Null model: "analytic" = exact binomial survival thresholds
    # (deterministic re-derivation of the reference's bootstrap table,
    # helper_scripts/calculate_null.py); or a path to an
    # inStrain-format NullModel.txt for bit-parity with a given table.
    null_model: str = "analytic"
    null_model_error_rate: float = 0.001
    null_model_max_coverage: int = 10000


@dataclass
class ProfileConfig:
    """`profile` operation (reference: argumentParser.py:134-180)."""

    output: str = "instrain_tpu"
    use_full_fasta_header: bool = False
    force_compress: bool = False
    processes: int = 6                 # host-side decode threads
    database_mode: bool = False
    min_scaffold_reads: int = 1
    min_genome_coverage: float = 0.0
    min_snp: int = 20                  # min reads linking two SNVs for LD
    store_everything: bool = False
    scaffolds_to_profile: Optional[str] = None
    rarefied_coverage: int = 50
    window_length: int = 10000
    skip_genome_wide: bool = False
    skip_plot_generation: bool = False
    skip_mm_profiling: bool = False
    mm_level: bool = False
    gene_file: Optional[str] = None
    stb: List[str] = field(default_factory=list)
    detailed_mapping_info: bool = False
    debug: bool = False

    filter: ReadFilterConfig = field(default_factory=ReadFilterConfig)
    variant: VariantConfig = field(default_factory=VariantConfig)

    # device execution parameters (no reference equivalent; replaces the
    # reference's process-pool cost model, profile_controller.py:397-465)
    engine: str = "auto"               # auto|dense|hybrid|batch kernel path
    max_mm_buckets: int = 33           # dense mm-axis width before bucketing
    position_tile: int = 16384         # positions per device tile (pad unit)
    seed: int = 42                     # PRNG key for rarefied metrics
    # multi-chip: shard the profile kernels over the first N devices of a
    # 1-D jax.sharding.Mesh (0/1 = single device). Replaces the
    # reference's worker pools (profile_controller.py:157-193); see
    # parallel/mesh.py for the sharding layouts.
    mesh_devices: int = 0
    # multi-host output policy: "primary" (default) — only process 0
    # writes the tables/TSVs after the allgather, matching the
    # reference's single-output model; "all" — every host materializes
    # a complete identical profile dir (the byte-identity test mode)
    distributed_store: str = "primary"

    def apply_database_mode(self) -> "ProfileConfig":
        """reference: controller.py:211-214."""
        if self.database_mode:
            self.filter.min_read_ani = 0.92
            self.skip_mm_profiling = True
            self.min_genome_coverage = 1
        return self


@dataclass
class CompareConfig:
    """`compare` operation (reference: argumentParser.py:183-239)."""

    output: str = "instrainComparer"
    processes: int = 6
    stb: List[str] = field(default_factory=list)
    min_cov: int = 5
    min_freq: float = 0.05
    fdr: float = 1e-6
    null_model: str = "analytic"
    database_mode: bool = False
    breadth: float = 0.5
    scaffolds: Optional[str] = None
    genome: Optional[str] = None
    store_coverage_overlap: bool = False
    store_mismatch_locations: bool = False
    include_self_comparisons: bool = False
    skip_plot_generation: bool = False
    group_length: int = 10_000_000
    force_compress: bool = False
    ani_threshold: float = 0.99999
    coverage_treshold: float = 0.1    # (sic) reference spelling kept for CLI parity
    clusterAlg: str = "average"
    bams: List[str] = field(default_factory=list)
    skip_popANI: bool = False
    # overlap-count engine: auto | host | device (kernels/compare.py —
    # device = all-pairs bf16 einsum over bit-packed masks)
    engine: str = "auto"


def config_from_kwargs(cls, kwargs: dict):
    """Build a (possibly nested) config dataclass from a flat kwargs dict."""
    names = {f.name: f for f in dataclasses.fields(cls)}
    init = {}
    for name, f in names.items():
        if dataclasses.is_dataclass(f.type) or f.type in (ReadFilterConfig, VariantConfig):
            sub_cls = f.default_factory() .__class__ if f.default_factory is not dataclasses.MISSING else None
            if sub_cls is not None:
                init[name] = config_from_kwargs(sub_cls, kwargs)
                continue
        if name in kwargs and kwargs[name] is not None:
            init[name] = kwargs[name]
    return cls(**init)
