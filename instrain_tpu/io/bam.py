"""
ctypes bindings for the native BAM decoder (native/bam.cc, baq.cc).

Decodes a whole sorted BAM into flat numpy arrays:
  - a per-record table with the fields the reference extracts via pysam for
    read filtering (NM, mapq, inferred length, ref start/end; reference:
    inStrain/filter_reads.py:885-955)
  - a per-aligned-base event stream (ref position, base code, quality) for
    the pileup kernels (replacing pysam.pileup, profile_utilities.py:150-153)

Quality post-processing (BAQ + mate-overlap tweak) mirrors the reference's
pileup parameters compute_baq=True, ignore_overlaps=True; pass
`baq=False` / `tweak_overlaps=False` to disable.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libinstrain_io.so")
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        # build from native/ on first use; the compiler's errors reach
        # stderr as they are
        subprocess.run(["make", "--no-print-directory"],
                       cwd=os.path.abspath(_NATIVE_DIR), check=True,
                       stdout=subprocess.DEVNULL)
    lib = ct.CDLL(_LIB_PATH)
    lib.bd_open.restype = ct.c_void_p
    lib.bd_open.argtypes = [ct.c_char_p, ct.c_int]
    lib.bd_open_sam.restype = ct.c_void_p
    lib.bd_open_sam.argtypes = [ct.c_char_p]
    lib.bd_open_ranged.restype = ct.c_void_p
    lib.bd_open_ranged.argtypes = [ct.c_char_p, ct.c_int, ct.c_char_p]
    lib.bd_error.restype = ct.c_char_p
    lib.bd_free.argtypes = [ct.c_void_p]
    lib.bd_ref_name.restype = ct.c_char_p
    lib.bd_ref_name.argtypes = [ct.c_void_p, ct.c_int64]
    lib.bd_qname_blob.restype = ct.c_void_p
    lib.bd_qname_blob.argtypes = [ct.c_void_p]
    for name in ["bd_n_refs", "bd_n_records", "bd_n_events",
                 "bd_n_qnames", "bd_qname_blob_len"]:
        getattr(lib, name).restype = ct.c_int64
        getattr(lib, name).argtypes = [ct.c_void_p]
    lib.bd_ref_len.restype = ct.c_int64
    lib.bd_ref_len.argtypes = [ct.c_void_p, ct.c_int64]
    ptr_funcs = {
        "bd_rec_ref_id": ct.c_int32, "bd_rec_pos": ct.c_int32,
        "bd_rec_flag": ct.c_uint16, "bd_rec_mapq": ct.c_uint8,
        "bd_rec_nm": ct.c_int32, "bd_rec_qname_id": ct.c_int64,
        "bd_rec_qlen_infer": ct.c_int32, "bd_rec_ref_start": ct.c_int32,
        "bd_rec_ref_end": ct.c_int32, "bd_rec_tlen": ct.c_int32,
        "bd_rec_mate_pos": ct.c_int32, "bd_rec_mate_ref": ct.c_int32,
        "bd_rec_ev_off": ct.c_int64,
        "bd_rec_ev_len": ct.c_int32, "bd_rec_pileup_ok": ct.c_uint8,
        "bd_ev_pos": ct.c_int32, "bd_ev_base": ct.c_uint8,
        "bd_ev_qual": ct.c_uint8, "bd_qname_off": ct.c_int64,
    }
    for name, typ in ptr_funcs.items():
        fn = getattr(lib, name)
        fn.restype = ct.POINTER(typ)
        fn.argtypes = [ct.c_void_p]
    lib.bd_apply_baq.argtypes = [ct.c_void_p, ct.c_int32,
                                 ct.POINTER(ct.c_uint8), ct.c_int64]
    lib.bd_tweak_overlaps.argtypes = [ct.c_void_p]
    lib.bd_tweak_overlaps_ex.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
    lib.bd_build_counts.restype = ct.c_int64
    lib.bd_build_counts.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32), ct.c_int32,
        ct.c_int64, ct.POINTER(ct.c_int32), ct.c_uint8]
    lib.bd_build_counts16.restype = ct.c_int32
    lib.bd_build_counts16.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32), ct.c_int32,
        ct.c_int64, ct.c_int64, ct.POINTER(ct.c_int16),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32), ct.c_uint8]
    lib.bd_pack_counts_sparse_d16.restype = ct.c_int64
    lib.bd_pack_counts_sparse_d16.argtypes = [
        ct.POINTER(ct.c_int16), ct.c_int64, ct.POINTER(ct.c_uint16),
        ct.POINTER(ct.c_uint8), ct.c_int64, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int64)]
    lib.bd_total_cum16.restype = None
    lib.bd_total_cum16.argtypes = [
        ct.POINTER(ct.c_int16), ct.c_int32, ct.c_int64,
        ct.POINTER(ct.c_int32)]
    lib.bd_clon_cum16.restype = None
    lib.bd_clon_cum16.argtypes = [
        ct.POINTER(ct.c_int16), ct.c_int32, ct.c_int64, ct.c_int32,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_float)]
    lib.bd_select_events.restype = ct.c_int64
    lib.bd_select_events.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_uint8), ct.c_int64, ct.c_uint8,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint8),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64), ct.c_int64]
    lib.bd_baq_one.restype = ct.c_int
    lib.bd_baq_one.argtypes = [
        ct.POINTER(ct.c_uint8), ct.c_int64, ct.c_int64,
        ct.POINTER(ct.c_uint32), ct.c_int,
        ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_uint8), ct.c_int,
        ct.POINTER(ct.c_uint8)]
    _lib = lib
    return lib


def _is_sam(path: str) -> bool:
    if path.endswith(".sam"):
        return True
    with open(path, "rb") as f:
        head = f.read(4)
    return not (head[:2] == b"\x1f\x8b" or head == b"BAM\x01")


class _NativeHandle:
    """Owns a native BamData* — freed when the last reference (BamArrays
    or any zero-copy array view) dies."""

    __slots__ = ("h",)

    def __init__(self, h):
        self.h = h

    def __del__(self):
        if not self.h:
            return
        try:
            lib = _load_lib()
        except Exception:  # interpreter shutdown
            return
        if lib is not None and getattr(lib, "bd_free", None):
            lib.bd_free(self.h)
        self.h = None


class _OwnedArray(np.ndarray):
    """ndarray view into native decoder memory holding a reference to the
    owning BamArrays, so the buffer outlives any view/slice of it."""

    _owner = None

    def __array_finalize__(self, obj):
        # propagate ownership only to true views (base chains to the
        # native buffer); ufunc results / copies have fresh buffers and
        # must not pin the native allocation
        if obj is not None and self.base is not None:
            self._owner = getattr(obj, "_owner", None)


def _arr(ptr, n, dtype, owner=None):
    """Zero-copy read-only view of a native buffer. Copies here are
    catastrophic: this host throttles large memory copies (a 150 MB
    .astype once cost ~35 s); the native handle stays alive via the
    owner backref instead."""
    if n == 0:
        return np.empty(0, dtype=dtype)
    a = np.ctypeslib.as_array(ptr, shape=(n,))
    assert a.dtype == dtype, (a.dtype, dtype)
    v = a.view(_OwnedArray)
    v._owner = owner
    v.flags.writeable = False
    return v


@dataclass
class BamArrays:
    """Decoded BAM as flat numpy arrays — zero-copy read-only views into
    the native decoder's buffers (the _NativeHandle owner is referenced by
    every view, so the memory lives as long as any array does)."""

    ref_names: List[str]
    ref_lens: np.ndarray          # int64 [n_refs]
    # record table
    ref_id: np.ndarray            # int32
    pos: np.ndarray               # int32
    flag: np.ndarray              # uint16
    mapq: np.ndarray              # uint8
    nm: np.ndarray                # int32
    qname_id: np.ndarray          # int64
    qlen_infer: np.ndarray        # int32
    ref_start: np.ndarray         # int32
    ref_end: np.ndarray           # int32
    tlen: np.ndarray              # int32 template length (BAM TLEN)
    mate_pos: np.ndarray          # int32 mate 0-based pos (-1 if unknown)
    mate_ref: np.ndarray          # int32 mate ref id (-1 if unknown)
    ev_off: np.ndarray            # int64
    ev_len: np.ndarray            # int32
    pileup_ok: np.ndarray         # uint8 (bool)
    # events
    ev_pos: np.ndarray            # int32
    ev_base: np.ndarray           # uint8
    ev_qual: np.ndarray           # uint8
    # qnames (lazy: materializing 10k+ Python strings costs more than the
    # decode itself; most paths only need counts/ids)
    _qnames: Optional[List[str]] = None
    n_qnames: int = 0
    # True when this decode came from the .bai-guided ranged path
    ranged: bool = False
    # native handle owner (kept open for native pileup/count building;
    # the decoded arrays are zero-copy views into it)
    _handle_obj: Optional[_NativeHandle] = None

    @property
    def _handle(self):
        ho = self._handle_obj
        return ho.h if ho is not None else None

    @property
    def qnames(self) -> Optional[List[str]]:
        if self._qnames is None and self._handle:
            lib = _load_lib()
            nq = lib.bd_n_qnames(self._handle)
            blob = ct.string_at(lib.bd_qname_blob(self._handle),
                                lib.bd_qname_blob_len(self._handle))
            self._qnames = [s.decode() for s in blob.split(b"\0")[:nq]]
        return self._qnames

    def close(self):
        """Drop this object's handle reference; the native memory is freed
        once the last zero-copy array view dies with it."""
        self._handle_obj = None

    def build_counts(self, rid: int, qid2mmidx: np.ndarray, n_mm: int,
                     L: int, min_qual: int = 30):
        """Native event->counts scatter: counts[n_mm, 4, L] int32."""
        assert self._handle, "native handle closed"
        lib = _load_lib()
        q = np.ascontiguousarray(qid2mmidx, dtype=np.int32)
        out = np.zeros(n_mm * 4 * L, dtype=np.int32)
        lib.bd_build_counts(self._handle, rid,
                            q.ctypes.data_as(ct.POINTER(ct.c_int32)),
                            n_mm, L,
                            out.ctypes.data_as(ct.POINTER(ct.c_int32)),
                            min_qual)
        return out.reshape(n_mm, 4, L)

    def build_counts_padded(self, rid: int, qid2mmidx: np.ndarray,
                            n_mm: int, L: int, Lp: int, Mp: int,
                            min_qual: int = 30):
        """
        Native event->counts scatter straight into a padded int16 tensor
        [Mp, 4, Lp] ready for device transfer (empty mm levels dropped in
        the same pass). Returns (counts16, level_events[n_mm], level_map)
        or None if any cell would overflow int16 — the caller falls back
        to the int32 path (coverage > 32767 at a single exact-mm cell).
        """
        assert self._handle, "native handle closed"
        assert Mp >= n_mm and Lp >= L
        lib = _load_lib()
        q = np.ascontiguousarray(qid2mmidx, dtype=np.int32)
        out = np.zeros(Mp * 4 * Lp, dtype=np.int16)
        level_events = np.zeros(n_mm, dtype=np.int64)
        level_map = np.zeros(n_mm, dtype=np.int32)
        kept = lib.bd_build_counts16(
            self._handle, rid,
            q.ctypes.data_as(ct.POINTER(ct.c_int32)), n_mm, L, Lp,
            out.ctypes.data_as(ct.POINTER(ct.c_int16)),
            level_events.ctypes.data_as(ct.POINTER(ct.c_int64)),
            level_map.ctypes.data_as(ct.POINTER(ct.c_int32)), min_qual)
        if kept < 0:
            return None
        return out.reshape(Mp, 4, Lp), level_events, level_map

    def select_events(self, rid: int, qid2mmidx: np.ndarray,
                      pos_mask: np.ndarray, min_qual: int = 30,
                      capacity: int = 1 << 20):
        """Counted events at masked positions: (pos, base, mm_idx, qname)."""
        assert self._handle, "native handle closed"
        lib = _load_lib()
        q = np.ascontiguousarray(qid2mmidx, dtype=np.int32)
        mask = np.ascontiguousarray(pos_mask, dtype=np.uint8)
        L = len(mask)
        while True:
            pos = np.empty(capacity, dtype=np.int32)
            base = np.empty(capacity, dtype=np.uint8)
            mm = np.empty(capacity, dtype=np.int32)
            qn = np.empty(capacity, dtype=np.int64)
            n = lib.bd_select_events(
                self._handle, rid,
                q.ctypes.data_as(ct.POINTER(ct.c_int32)),
                mask.ctypes.data_as(ct.POINTER(ct.c_uint8)), L, min_qual,
                pos.ctypes.data_as(ct.POINTER(ct.c_int32)),
                base.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                mm.ctypes.data_as(ct.POINTER(ct.c_int32)),
                qn.ctypes.data_as(ct.POINTER(ct.c_int64)), capacity)
            if n <= capacity:
                return pos[:n], base[:n], mm[:n], qn[:n]
            capacity = int(n)

    @property
    def n_records(self) -> int:
        return len(self.ref_id)

    @property
    def name_to_ref_id(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.ref_names)}

    def records_of_ref(self, rid: int) -> np.ndarray:
        """Indices of records on reference rid, preserving file order."""
        return np.nonzero(self.ref_id == rid)[0]


def decode_bam(path: str, ref_seqs: Optional[Dict[str, np.ndarray]] = None,
               threads: int = 6, baq: bool = False,
               tweak_overlaps: bool = True,
               tweak_orphans: bool = False,
               tweak_legacy_walk: bool = True,
               scaffolds: Optional[List[str]] = None) -> BamArrays:
    """
    Decode a BAM file.

    ref_seqs: {ref_name: uint8 ASCII array} — required for BAQ (uppercased
    reference sequences, e.g. from io.fasta.read_fasta).
    scaffolds: decode ONLY these scaffolds via the .bai-guided ranged
    path (native bd_open_ranged); falls back to a full decode when no
    index exists. The result's `ranged` flag records which path ran.
    """
    lib = _load_lib()
    ranged = False
    h = None
    if _is_sam(path):
        h = lib.bd_open_sam(path.encode())
    else:
        if scaffolds is not None:
            bais = [path + ".bai"]
            if path.endswith(".bam"):
                bais.append(path[:-4] + ".bai")
            if any(os.path.exists(b) for b in bais):
                h = lib.bd_open_ranged(path.encode(), threads,
                                       "\n".join(scaffolds).encode())
                if h:
                    ranged = True
                else:
                    import logging
                    logging.debug(
                        f"ranged decode failed "
                        f"({lib.bd_error().decode()}); full decode")
        if h is None or not h:
            h = lib.bd_open(path.encode(), threads)
    if not h:
        raise IOError(f"BAM decode failed: {lib.bd_error().decode()}")
    try:
        n_refs = lib.bd_n_refs(h)
        ref_names = [lib.bd_ref_name(h, i).decode() for i in range(n_refs)]
        ref_lens = np.array([lib.bd_ref_len(h, i) for i in range(n_refs)],
                            dtype=np.int64)

        if baq:
            if ref_seqs is None:
                raise ValueError("BAQ requires ref_seqs")
            for i, name in enumerate(ref_names):
                if name not in ref_seqs:
                    continue
                seq = np.ascontiguousarray(ref_seqs[name], dtype=np.uint8)
                lib.bd_apply_baq(h, i,
                                 seq.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                                 len(seq))
        if tweak_overlaps:
            lib.bd_tweak_overlaps_ex(h, int(tweak_orphans),
                                     int(tweak_legacy_walk))

        n = lib.bd_n_records(h)
        ne = lib.bd_n_events(h)
        ho = _NativeHandle(h)
        h = None  # ownership transferred to the handle object
        hp = ho.h
        out = BamArrays(
            ref_names=ref_names,
            ref_lens=ref_lens,
            ref_id=_arr(lib.bd_rec_ref_id(hp), n, np.int32, ho),
            pos=_arr(lib.bd_rec_pos(hp), n, np.int32, ho),
            flag=_arr(lib.bd_rec_flag(hp), n, np.uint16, ho),
            mapq=_arr(lib.bd_rec_mapq(hp), n, np.uint8, ho),
            nm=_arr(lib.bd_rec_nm(hp), n, np.int32, ho),
            qname_id=_arr(lib.bd_rec_qname_id(hp), n, np.int64, ho),
            qlen_infer=_arr(lib.bd_rec_qlen_infer(hp), n, np.int32, ho),
            ref_start=_arr(lib.bd_rec_ref_start(hp), n, np.int32, ho),
            ref_end=_arr(lib.bd_rec_ref_end(hp), n, np.int32, ho),
            tlen=_arr(lib.bd_rec_tlen(hp), n, np.int32, ho),
            mate_pos=_arr(lib.bd_rec_mate_pos(hp), n, np.int32, ho),
            mate_ref=_arr(lib.bd_rec_mate_ref(hp), n, np.int32, ho),
            ev_off=_arr(lib.bd_rec_ev_off(hp), n, np.int64, ho),
            ev_len=_arr(lib.bd_rec_ev_len(hp), n, np.int32, ho),
            pileup_ok=_arr(lib.bd_rec_pileup_ok(hp), n, np.uint8, ho),
            ev_pos=_arr(lib.bd_ev_pos(hp), ne, np.int32, ho),
            ev_base=_arr(lib.bd_ev_base(hp), ne, np.uint8, ho),
            ev_qual=_arr(lib.bd_ev_qual(hp), ne, np.uint8, ho),
        )
        out.n_qnames = int(lib.bd_n_qnames(hp))
        out.ranged = ranged
        out._handle_obj = ho
        return out
    finally:
        if h:
            lib.bd_free(h)


def pack_counts_sparse_d16_into(counts16: np.ndarray,
                                delta_out: np.ndarray,
                                vals_out: np.ndarray, corr_idx: np.ndarray,
                                corr_val: np.ndarray):
    """Delta-encoded sparse pack of ONE int16 count tensor into
    preallocated wire slices: delta_out uint16 (gap from the previous
    emitted dense flat index; >65535 gaps chain through zero-value
    entries), vals_out uint8 saturated values, corr_idx/corr_val int32
    corrections for cells > 255. The device reconstructs
    idx = cumsum(delta) - 1 and scatter-adds (kernels/sitestats.py:
    _densify_sparse_d16); caller-zeroed padding self-neutralizes
    (delta 0 / value 0). Returns (nnz, ncorr) — either may exceed its
    buffer, in which case the caller re-packs with larger buffers
    (known before any kernel launch)."""
    lib = _load_lib()
    assert counts16.dtype == np.int16
    assert delta_out.dtype == np.uint16 and len(delta_out) == len(vals_out)
    flat = np.ascontiguousarray(counts16).reshape(-1)
    ncorr = ct.c_int64(0)
    nnz = lib.bd_pack_counts_sparse_d16(
        flat.ctypes.data_as(ct.POINTER(ct.c_int16)), flat.size,
        delta_out.ctypes.data_as(ct.POINTER(ct.c_uint16)),
        vals_out.ctypes.data_as(ct.POINTER(ct.c_uint8)), vals_out.size,
        corr_idx.ctypes.data_as(ct.POINTER(ct.c_int32)),
        corr_val.ctypes.data_as(ct.POINTER(ct.c_int32)), len(corr_idx),
        ct.byref(ncorr))
    return int(nnz), int(ncorr.value)


def total_cum16(counts16: np.ndarray, n_mm: int) -> np.ndarray:
    """Cumulative coverage total [n_mm, Lp] int32 from an int16 count
    tensor [Mp, 4, Lp] — native host pass (numpy here is
    bandwidth-throttled); matches the device's cum.sum(axis=bases)."""
    lib = _load_lib()
    c = np.ascontiguousarray(counts16)
    assert c.dtype == np.int16 and c.ndim == 3 and c.shape[1] == 4
    Lp = c.shape[2]
    out = np.empty((n_mm, Lp), dtype=np.int32)
    lib.bd_total_cum16(c.ctypes.data_as(ct.POINTER(ct.c_int16)), n_mm, Lp,
                       out.ctypes.data_as(ct.POINTER(ct.c_int32)))
    return out


def clon_cum16(counts16: np.ndarray, n_mm: int, min_cov: int):
    """One native pass over an int16 count tensor [Mp, 4, Lp]:
    (total int32 [n_mm, Lp], clonality float32 [n_mm, Lp] with NaN where
    the exact level is absent or coverage < min_cov) — mirrors the device
    kernel's `total` and `clon` so neither crosses the device link."""
    lib = _load_lib()
    c = np.ascontiguousarray(counts16)
    assert c.dtype == np.int16 and c.ndim == 3 and c.shape[1] == 4
    Lp = c.shape[2]
    total = np.empty((n_mm, Lp), dtype=np.int32)
    clon = np.empty((n_mm, Lp), dtype=np.float32)
    lib.bd_clon_cum16(c.ctypes.data_as(ct.POINTER(ct.c_int16)), n_mm, Lp,
                      min_cov, total.ctypes.data_as(ct.POINTER(ct.c_int32)),
                      clon.ctypes.data_as(ct.POINTER(ct.c_float)))
    return total, clon


def baq_one(ref_codes: np.ndarray, pos: int, cigar: np.ndarray,
            seq_codes: np.ndarray, qual: np.ndarray) -> np.ndarray:
    """Standalone BAQ for one alignment (testing)."""
    lib = _load_lib()
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    seq_codes = np.ascontiguousarray(seq_codes, dtype=np.uint8)
    qual = np.ascontiguousarray(qual, dtype=np.uint8)
    out = qual.copy()
    rc = lib.bd_baq_one(
        ref_codes.ctypes.data_as(ct.POINTER(ct.c_uint8)), len(ref_codes),
        pos, cigar.ctypes.data_as(ct.POINTER(ct.c_uint32)), len(cigar),
        seq_codes.ctypes.data_as(ct.POINTER(ct.c_uint8)),
        qual.ctypes.data_as(ct.POINTER(ct.c_uint8)), len(qual),
        out.ctypes.data_as(ct.POINTER(ct.c_uint8)))
    if rc != 0:
        return qual.copy()
    return out
