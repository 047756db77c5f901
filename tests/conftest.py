"""
Test configuration.

Forces the CPU backend, with 8 virtual devices for the sharding tests,
BEFORE jax is imported anywhere. Subprocesses inherit both settings.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# 8 virtual devices share 2 host cores here: raise the CPU collective
# rendezvous watchdog (default 40 s aborts the process on thread skew)
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") +
    " --xla_force_host_platform_device_count=8"
    " --xla_cpu_collective_call_terminate_timeout_seconds=1200")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_DATA = "/root/reference/test/test_data"
REF_NULL = "/root/reference/inStrain/helper_files/NullModel.txt"


@pytest.fixture(autouse=True, scope="module")
def _isolate_ambient_globals():
    """Order-independence guard: reference-oracle imports (and product
    plotting modules) mutate matplotlib.rcParams process-wide; snapshot and
    restore per test module so no module can poison a later one."""
    try:
        import matplotlib
        saved = matplotlib.rcParams.copy()
    except ImportError:
        saved = None
    yield
    if saved is not None:
        import matplotlib
        dict.update(matplotlib.rcParams, saved)


def _require(path):
    if not os.path.exists(path):
        pytest.skip(f"reference fixture {path} not available")
    return path


@pytest.fixture(scope="session")
def sars_bam():
    return _require(os.path.join(
        REF_DATA, "sars_cov_2_MT039887.1.fasta.bt2-vs-SRR11140750.sorted.bam"))


@pytest.fixture(scope="session")
def sars_is():
    return _require(os.path.join(
        REF_DATA, "sars_cov_2_MT039887.1.fasta.bt2-vs-SRR11140750.sam.IS"))


@pytest.fixture(scope="session")
def sars_ref_seq():
    """SARS-CoV-2 genome from the shipped GenBank file."""
    import re
    path = _require(os.path.join(REF_DATA, "sars_cov_2_MT039887.1.gb"))
    txt = open(path).read()
    seq = "".join(re.findall("[a-zA-Z]+",
                             txt.split("ORIGIN")[1].split("//")[0])).upper()
    return np.frombuffer(seq.encode(), dtype=np.uint8)


@pytest.fixture(scope="session")
def ref_null_model():
    return _require(REF_NULL)


@pytest.fixture(scope="session")
def small_bam():
    return _require(os.path.join(REF_DATA, "SmallScaffold.fa.sorted.bam"))


@pytest.fixture(scope="session")
def small_fasta():
    return _require(os.path.join(REF_DATA, "SmallScaffold.fa"))


@pytest.fixture(scope="session")
def sars_profiled(sars_bam, sars_ref_seq, ref_null_model):
    """Decoded + filtered + site-stats profiled sars scaffold (shared)."""
    from instrain_tpu.config import ReadFilterConfig, VariantConfig
    from instrain_tpu.io.bam import decode_bam
    from instrain_tpu.io.fasta import seq_to_codes
    from instrain_tpu.profile.filter_reads import filter_reads
    from instrain_tpu.profile.pileup import (build_scaffold_pileup, make_luts,
                                             run_site_stats)

    bam = decode_bam(sars_bam, ref_seqs={"MT039887.1": sars_ref_seq},
                     baq=False)
    pairs = filter_reads(bam, ReadFilterConfig())
    pu = build_scaffold_pileup(bam, pairs, 0, len(sars_ref_seq))
    vc = VariantConfig(null_model=ref_null_model)
    null_lut, freq_lut = make_luts(vc)
    stats = run_site_stats(pu, seq_to_codes(sars_ref_seq), null_lut, freq_lut)
    return dict(bam=bam, pairs=pairs, pileup=pu, stats=stats,
                ref_codes=seq_to_codes(sars_ref_seq))
