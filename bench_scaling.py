#!/usr/bin/env python
"""
Scaling harness: the REAL profile step (run_site_stats_hybrid — the same
function profile() dispatches to, position-sharded via
ProfileConfig.mesh_devices) at 1..8 devices on a virtual CPU mesh.

A CPU-only simulation: it measures the SPMD partitioning overhead and
scaling shape of the step itself, not a GPU. `python chip_smoke.py
--multi` checks the same sharded paths on real devices. Prints one JSON
line per mesh size plus summary efficiency figures.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# 8 virtual devices may oversubscribe the host's cores: raise the CPU
# collective rendezvous watchdog (its 40 s default aborts on thread skew)
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") +
    " --xla_force_host_platform_device_count=8"
    " --xla_cpu_collective_call_terminate_timeout_seconds=1200")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
    from instrain_tpu.kernels.sitestats import freq_min_count_lut
    from instrain_tpu.parallel.mesh import make_mesh
    from instrain_tpu.profile import compact
    from instrain_tpu.profile.pileup import ScaffoldPileup

    rng = np.random.default_rng(0)
    # ~256k positions (bucket pads to a mesh-divisible 256 Ki); the
    # 50-draw rarefied scan makes bigger scaffolds too slow for this
    # memory-throttled CPU host
    M, L = 8, (1 << 18) - 5
    counts = rng.integers(0, 6, (M, 4, L)).astype(np.int32)
    counts[rng.random((M, 4, L)) < 0.7] = 0
    refs = rng.integers(0, 4, L).astype(np.uint8)
    pu = ScaffoldPileup(name="bench", rid=0, length=L,
                        mm_values=np.arange(M), counts=counts)
    null_lut = analytic_null_thresholds(max_coverage=1000)
    freq_lut = freq_min_count_lut(0.05, max_coverage=1000)

    times = {}
    for n in (1, 2, 4, 8):
        if n > len(jax.devices()):
            continue
        mesh = make_mesh(n) if n > 1 else None
        # warm (compile)
        compact.run_site_stats_hybrid(pu, refs, null_lut, freq_lut,
                                      mesh=mesh)
        # min over repeats: this host's CPU is noisy (2-3x run-to-run
        # swings); the min measures the step, not the scheduler weather
        reps = []
        for _ in range(3):
            t0 = time.time()
            compact.run_site_stats_hybrid(pu, refs, null_lut, freq_lut,
                                          mesh=mesh)
            reps.append(time.time() - t0)
        dt = min(reps)
        times[n] = dt
        print(json.dumps({"mesh_devices": n, "step_s": round(dt, 4),
                          "positions_per_sec": round(L / dt, 1)}))
    if 1 in times and 2 in times:
        eff2 = times[1] / (2 * times[2])
        print(json.dumps({"metric": "scaling_efficiency_1to2",
                          "value": round(eff2, 3)}))
    if 1 in times and 8 in times:
        eff8 = times[1] / (8 * times[8])
        print(json.dumps({"metric": "scaling_efficiency_1to8",
                          "value": round(eff8, 3)}))


if __name__ == "__main__":
    main()
