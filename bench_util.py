"""
Device-utilization accounting for the bench harnesses.

How far are the hot kernels from the device's peak memory bandwidth?
For the site-stats kernel launches the benchmark actually made, obtain
XLA's own post-optimization cost analysis (bytes accessed / FLOPs) and
divide by the measured on-device compute seconds and the device's peak
bandwidth.

The kernel entry points are spied by rebinding module attributes at
runtime, and cost analysis re-lowers the jitted function at the captured
shapes (hitting the in-process/persistent compile caches).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

# Peak device-memory bandwidth, bytes/s, keyed by the device_kind JAX
# reports. Source: NVIDIA H100 data sheet, SXM part (80 GB HBM3 at
# 3.35 TB/s, at the full 700 W power limit).
_HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}


def device_kind_and_peak():
    """(device_kind, peak bytes/s); a device without a recorded peak is
    an error, not a default."""
    import jax
    kind = jax.devices()[0].device_kind
    if kind not in _HBM_PEAK:
        raise KeyError(f"no peak bandwidth on record for device kind "
                       f"{kind!r}")
    return kind, _HBM_PEAK[kind]


_DEFAULT_TARGETS = (
    ("instrain_tpu.kernels.sitestats",
     ("site_stats_compact_batch_sparse", "site_stats_compact_sparse",
      "site_stats_compact", "site_stats_compact_batch")),
    ("instrain_tpu.kernels.linkage", ("ld_device",)),
)


class KernelSpy:
    """Capture the concrete (args, kwargs) of the first call per distinct
    compiled variant of selected jitted kernel entry points."""

    def __init__(self, targets=_DEFAULT_TARGETS):
        self.targets = targets
        self.calls: Dict[str, tuple] = {}

    @contextlib.contextmanager
    def active(self):
        import importlib
        origs = []
        try:
            for modname, names in self.targets:
                mod = importlib.import_module(modname)
                for name in names:
                    orig = getattr(mod, name)
                    origs.append((mod, name, orig))

                    def make(name=name, orig=orig):
                        def spy(*a, **k):
                            # one representative call per
                            # (name, static kwargs)
                            key = f"{name}|{sorted(k.items())!r}"
                            self.calls.setdefault(key, (name, orig, a, k))
                            return orig(*a, **k)
                        return spy
                    setattr(mod, name, make())
            yield self
        finally:
            for mod, name, orig in origs:
                setattr(mod, name, orig)

    def cost_analyses(self) -> List[Dict]:
        """XLA cost analysis per captured kernel variant. Best-effort:
        returns [] when the backend doesn't expose it."""
        out = []
        for name, orig, a, k in self.calls.values():
            ca = _cost_analysis(orig, a, k)
            if ca:
                shapes = [tuple(getattr(x, "shape", ())) for x in a]
                out.append({"kernel": name, "arg_shapes": shapes, **ca})
        return out


def _cost_analysis(fn, args, kwargs) -> Optional[Dict]:
    try:
        lowered = fn.lower(*args, **kwargs)
    except Exception:
        return None
    ca = None
    try:
        ca = lowered.compile().cost_analysis()
    except Exception:
        try:
            ca = lowered.cost_analysis()
        except Exception:
            return None
    if ca is None:
        return None
    # jax versions differ: dict, or list with one dict
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    get = ca.get if hasattr(ca, "get") else lambda *_: None
    bytes_accessed = get("bytes accessed")
    flops = get("flops")
    out = {}
    if bytes_accessed is not None:
        out["bytes_accessed"] = float(bytes_accessed)
    if flops is not None:
        out["flops"] = float(flops)
    return out or None


def device_util_summary(analyses: List[Dict], compute_s: float,
                        launches: int) -> Optional[Dict]:
    """Achieved HBM bytes/s vs peak for the dominant kernel.

    `compute_s` / `launches` come from compact.TIMINGS (synchronized
    wall time around each kernel call, which includes the dispatch
    round-trip — so `hbm_util` is a LOWER bound on true kernel HBM
    utilization)."""
    if not analyses or not compute_s or not launches:
        return None
    main = max(analyses, key=lambda d: d.get("bytes_accessed", 0.0))
    ba = main.get("bytes_accessed")
    if not ba:
        return None
    kind, peak = device_kind_and_peak()
    per_launch_s = compute_s / launches
    achieved = ba / per_launch_s
    return {
        "kernel": main["kernel"],
        "bytes_accessed_per_launch": ba,
        "flops_per_launch": main.get("flops"),
        "launches": launches,
        "compute_s_per_launch": per_launch_s,
        "achieved_bytes_per_s": achieved,
        "device_kind": kind,
        "hbm_peak_bytes_per_s": peak,
        "hbm_util": achieved / peak,
    }
