"""
instrain_tpu — an accelerator-native strain-profiling framework.

Computes strain-level metrics from metagenomic read mappings: given a sorted
BAM mapped to a FASTA of scaffolds it produces per-scaffold / gene / genome
pileup base counts, coverage/breadth, clonality (nucleotide diversity),
SNV/SNS calls against a sequencing-error null model, SNV linkage
disequilibrium, gene-level dN/dS & pN/pS, genome-wide aggregation (incl.
iRep), and profile-vs-profile comparison (conANI/popANI, strain clustering,
SNV pooling).

Feature-level reference: MrOlm/inStrain v1.9.1 (see SURVEY.md). A native
C++ BAM decoder emits packed read tensors, pileups and site statistics run
as JAX/XLA kernels over position-major count arrays on the GPU, and
scaffolds shard across a `jax.sharding.Mesh` for multi-device execution.
"""

__version__ = "0.1.0"

# Version of the reference whose capabilities / output schema we match
# (inStrain/_version.py in the reference tree).
__capability_version__ = "1.9.1"

# 64-bit types: the compact device kernels accumulate integer/float sums
# exactly (int64/float64) so host-side statistics match numpy float64
# semantics; dtypes in hot paths remain explicitly 32-bit.
import jax as _jax

_jax.config.update("jax_enable_x64", True)
