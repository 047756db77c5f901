"""
The engines chip_smoke.py checks on the GPU, checked here on the CPU at a
small size with its own comparison rules: batch and hybrid against dense,
device linkage against host. Also the compile-cache placement, the zlib
build of the native decoder, and chip_smoke.py refusing to run without a
GPU. Every input comes from the shared seeded generator
(bench_batch.synth); nothing is read from outside the repo.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import bench_batch
import chip_smoke
import instrain_tpu.kernels.sitestats as K
from instrain_tpu.profile.pipeline import choose_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def many_small(tmp_path_factory):
    """20 scaffolds x 5 kb at 30x: the batch engine's side of `auto`."""
    return bench_batch.synth(str(tmp_path_factory.mktemp("many")),
                             n_scaffolds=20, length=5000, seed=3)


@pytest.fixture(scope="module")
def few_long(tmp_path_factory):
    """2 scaffolds x 30 kb at 30x: the hybrid engine's side of `auto`."""
    return bench_batch.synth(str(tmp_path_factory.mktemp("few")),
                             n_scaffolds=2, length=30_000, seed=5)


def test_batch_engine_matches_dense_synthetic(many_small):
    fasta, bam, pairs = many_small
    with chip_smoke._Spy(K, "site_stats_compact_batch_sparse") as spy:
        engine, got = chip_smoke.profile_payloads(bam, fasta, "batch")
    assert engine == "batch" and spy.calls > 0
    _, ref = chip_smoke.profile_payloads(bam, fasta, "dense")
    counts = chip_smoke.compare_payloads(ref, got)
    assert counts["scaffolds"] == 20 and counts["snv_rows"] > 0
    assert pairs == 20 * 500


def test_hybrid_engine_and_device_linkage_match_host(few_long):
    from instrain_tpu.config import ProfileConfig
    from instrain_tpu.profile.linkage import (calculate_linkage,
                                              window_starts_for)
    from instrain_tpu.profile.pipeline import _read_and_filter
    fasta, bam, _ = few_long
    with chip_smoke._Spy(K, "site_stats_compact_sparse") as spy:
        engine, got = chip_smoke.profile_payloads(bam, fasta, "hybrid")
    assert engine == "hybrid" and spy.calls > 0
    _, ref = chip_smoke.profile_payloads(bam, fasta, "dense")
    assert chip_smoke.compare_payloads(ref, got)["linkage_rows"] > 0

    # linkage: ld_device against the host engine on the dense stats
    from instrain_tpu.profile.pileup import (build_scaffold_pileup,
                                             make_luts, run_site_stats)
    cfg = ProfileConfig()
    registry, bam_a, pairs, _ = _read_and_filter(bam, fasta, cfg)
    luts = make_luts(cfg.variant)
    rows = 0
    for name in registry.names:
        L = registry.length_of(name)
        st = run_site_stats(build_scaffold_pileup(
            bam_a, pairs, bam_a.name_to_ref_id[name], L),
            registry.codes[name], *luts)
        ws = window_starts_for(L, cfg.window_length)
        host = calculate_linkage(st, ws, engine="host")
        dev = calculate_linkage(st, ws, engine="device")
        rows += chip_smoke.compare_frames(
            host, dev, name, skip=chip_smoke.LINKAGE_RAREFIED)
    assert rows > 0


def test_compare_frames_rules():
    """The smoke's comparison: integers exact, f32 clonality columns to
    1e-6, other floats to 1e-9, NaN in the same places."""
    import pandas as pd
    a = pd.DataFrame({"position": [1, 2], "nucl_diversity": [0.5, np.nan],
                      "coverage": [3.0, 4.0]})
    chip_smoke.compare_frames(a, a.copy(), "same")
    near = a.assign(nucl_diversity=[0.5 * (1 + 5e-7), np.nan])
    chip_smoke.compare_frames(a, near, "f32 column")
    for bad in (a.assign(coverage=[3.0, 4.0 * (1 + 1e-7)]),
                a.assign(position=[1, 3]),
                a.assign(nucl_diversity=[0.5, 0.1])):
        with pytest.raises(chip_smoke.Mismatch):
            chip_smoke.compare_frames(a, bad, "bad")
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.compare_frames(a, near, "bit for bit", exact=True)


@pytest.mark.parametrize("engine,n,mesh,want", [
    ("auto", 100, None, "dense"),      # CPU backend, no mesh
    ("auto", 16, "mesh", "batch"),
    ("auto", 15, "mesh", "hybrid"),
    ("hybrid", 100, None, "hybrid"),
])
def test_choose_engine(engine, n, mesh, want):
    assert choose_engine(engine, n, mesh) == want


@pytest.mark.parametrize("set_var", [True, False])
def test_compile_cache_placement(tmp_path, set_var):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs go there and
    no directory is set in code; unset, the cache is <checkout>/.jax_cache."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    target = str(tmp_path / "cc")
    if set_var:
        env["JAX_COMPILATION_CACHE_DIR"] = target
    code = (
        "import jax, jax.numpy as jnp\n"
        "from instrain_tpu.cache import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()\n"
        "print(d); print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    helper_dir, jax_dir = out.stdout.split()[-2:]
    want = target if set_var else os.path.join(REPO, ".jax_cache")
    assert helper_dir == jax_dir == want
    if set_var:
        assert os.listdir(target), "nothing was cached in the set directory"


def test_zlib_decoder_build_matches(tmp_path, many_small):
    """The decoder built against zlib (`make INFLATE=zlib`, for hosts
    without libdeflate) decodes a BAM exactly as the default build."""
    lib = str(tmp_path / "libinstrain_io_zlib.so")
    subprocess.run(["make", "--no-print-directory", "INFLATE=zlib",
                    f"TARGET={lib}"], cwd=os.path.join(REPO, "native"),
                   check=True, stdout=subprocess.DEVNULL, timeout=300)
    code = (
        "import sys, hashlib, numpy as np\n"
        "import instrain_tpu.io.bam as b\n"
        "if len(sys.argv) > 2: b._LIB_PATH = sys.argv[2]\n"
        "a = b.decode_bam(sys.argv[1])\n"
        "h = hashlib.sha256()\n"
        "for f in ('ref_id', 'pos', 'flag', 'nm', 'ref_end', 'ev_len'):\n"
        "    h.update(np.ascontiguousarray(getattr(a, f)).tobytes())\n"
        "print(a.n_records, h.hexdigest())\n")
    bam = many_small[1]
    digests = [subprocess.run([sys.executable, "-c", code, bam] + extra,
                              cwd=REPO, capture_output=True, text=True,
                              check=True, timeout=120).stdout.split()
               for extra in ([], [lib])]
    assert digests[0] == digests[1] and int(digests[0][0]) == 20 * 1000


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without a GPU the smoke must exit non-zero, quickly, without
    printing its ok line."""
    import shutil
    if shutil.which("nvidia-smi"):
        pytest.skip("a GPU host: chip_smoke.py would run in full here")
    out = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr
