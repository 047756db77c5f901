"""
The profile directory object — on-disk format compatible with the
reference's SNVprofile (inStrain/SNVprofile.py:29-150).

Layout: <loc>/output, raw_data, log, figures; raw_data/attributes.tsv maps
attribute name -> (value-or-file, type, description). Typed payloads:
value, dictionary (json), list (txt), numpy (npz), pandas (csv.gz),
pickle, special (hd5: one gzip'd dataset per "scaffold::mm" holding
[values, index], selectively loadable per scaffold).

This cross-compatibility is deliberate: profiles written here load through
inStrain's Python API and vice versa (the golden test fixtures are read
with this class). h5py is imported only where a special attribute is
written or read.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from .. import __version__

SPECIAL_SERIES = {"covT", "snpsCounted", "clonT", "clonTR"}

# hd5 "special" dataset compression. The reference writes gzip
# (SNVprofile.py:717-748); lzf is ~2x faster to write, still
# a standard h5py filter the reference's h5py reads transparently
# (cross-compat tests read our profiles through the reference's
# SNVprofile), and selective per-scaffold loading is unaffected.
# INSTRAIN_H5_COMP=gzip restores byte-level reference parity.
_H5_COMP = os.environ.get("INSTRAIN_H5_COMP", "lzf")
if _H5_COMP in ("none", ""):
    _H5_COMP = None


def _special_pack(series: pd.Series) -> np.ndarray:
    """[values, index] 2-row array (reference layout,
    SNVprofile.py:717-748) in the NARROWEST exact dtype: readers on both
    sides rebuild the index with .astype(int) and take values as stored,
    so int32 / float32 storage halves the bytes hd5 writes + compresses
    — the stream writes sit on the batch engine's critical path. Falls
    back to the 8-byte upcast whenever a value or index would not be
    exact in 4 bytes (positions >= 2^24 for float32 indexes)."""
    vals = series.values
    idx = series.index.values
    n = len(idx)
    if np.issubdtype(vals.dtype, np.integer):
        if (n == 0 or (idx.max() < 2 ** 31 and idx.min() >= 0)) and \
           (n == 0 or (vals.min() >= -2 ** 31 and vals.max() < 2 ** 31)):
            return np.array([vals.astype(np.int32),
                             idx.astype(np.int32)])
        return np.array([vals, idx])
    if vals.dtype == np.float32 and (n == 0 or
                                     (0 <= idx.min() and
                                      idx.max() < 2 ** 24)):
        return np.array([vals, idx.astype(np.float32)])
    return np.array([vals.astype(np.float64), idx.astype(np.float64)])


class ProfileDir:
    """A profile/compare results directory (reference: SNVprofile)."""

    first_levels = ["output", "raw_data", "log", "figures"]

    def __init__(self, location: str):
        import threading
        self.location = os.path.abspath(location)
        # attributes.tsv is a read-modify-write registry; store()/
        # _register() may be called from a background thread (the batch
        # engine overlaps read-result stores with the device loop), so
        # every mutation holds this per-instance lock
        self._attr_lock = threading.RLock()
        self._make_structure()
        self._init_attributes()

    # ---------- public API ----------

    def store(self, name: str, value, typ: str, description: str):
        with self._attr_lock:
            return self._store_locked(name, value, typ, description)

    def _store_locked(self, name: str, value, typ: str, description: str):
        adb = self._get_attributes()
        if typ == "value":
            stored = value
        elif typ == "dictionary":
            stored = self._fileloc(name) + ".json"
            with open(stored, "w") as f:
                json.dump(value, f)
        elif typ == "list":
            stored = self._fileloc(name) + ".txt"
            with open(stored, "w") as f:
                for x in value:
                    f.write(str(x) + "\n")
        elif typ == "numpy":
            stored = self._fileloc(name) + ".npz"
            np.savez_compressed(stored, value)
        elif typ == "pandas":
            stored = self._fileloc(name) + ".csv.gz"
            value.to_csv(stored)
        elif typ == "pickle":
            stored = self._fileloc(name) + ".pickle"
            with open(stored, "wb") as f:
                pickle.dump(value, f)
        elif typ == "special":
            stored = self._store_special(name, value)
        else:
            raise ValueError(f"unknown attribute type {typ}")

        self._register(name, stored, typ, description, adb)

    def _register(self, name, stored, typ, description, adb=None):
        with self._attr_lock:
            if adb is None:
                adb = self._get_attributes()
            row = pd.DataFrame({"value": [stored], "type": [typ],
                                "description": [description]}, index=[name])
            if name in adb.index:
                adb.at[name, "value"] = stored
            else:
                adb = pd.concat([adb, row])
            self._store_attributes(adb)

    def open_special_stream(self, name: str, description: str
                            ) -> "SpecialStreamWriter":
        """Incremental writer for a 'special' hd5 attribute: one
        scaffold's mm->Series dict per write() call, so the compressed
        writes overlap upstream work instead of lumping after it. Same on-disk format as store(..., 'special');
        the attribute registers on close()."""
        return SpecialStreamWriter(self, name, description)

    def get(self, name: str, **kwargs):
        adb = self._get_attributes()
        if name not in adb.index:
            return None
        typ = adb.loc[name, "type"]
        if typ == "value":
            return adb.loc[name, "value"]
        filename = os.path.join(self.get_location("raw_data"),
                                os.path.basename(adb.loc[name, "value"]))
        if typ == "dictionary":
            with open(filename) as f:
                return json.load(f)
        if typ == "list":
            with open(filename) as f:
                return [l.strip() for l in f]
        if typ == "numpy":
            base = np.load(filename)
            return base[base.files[0]]
        if typ == "pandas":
            return pd.read_csv(filename, index_col=0)
        if typ == "pickle":
            with open(filename, "rb") as f:
                return pickle.load(f)
        if typ == "special":
            return self._load_special(filename, name, **kwargs)
        raise ValueError(f"unknown attribute type {typ}")

    def get_location(self, name: str) -> str:
        loc = os.path.join(self.location, name)
        if not os.path.exists(loc):
            os.makedirs(loc)
        return loc + "/"

    def get_output_base(self) -> str:
        return (self.get_location("output") +
                os.path.basename(self.get("location")) + "_")

    def keys(self) -> List[str]:
        return list(self._get_attributes().index)

    def load_output(self, name: str) -> pd.DataFrame:
        """Load an already-generated output TSV
        (reference: SNVprofile.load_output, 168-190)."""
        loc = self.get_output_base() + name
        files = glob.glob(loc + "*")
        assert len(files) < 2, files
        if not files:
            logging.error(f"{name} does not exist")
            return pd.DataFrame()
        if name == "mapping_info":
            return pd.read_csv(files[0], sep="\t", header=1)
        return pd.read_csv(files[0], sep="\t")

    def get_read_length(self) -> float:
        """reference: SNVprofile.get_read_length (458-460)."""
        rdb = self.get("mapping_info").head(1)
        return float(rdb["mean_pair_length"].iloc[0])

    def get_clonality_table(self, nonredundant: bool = True) -> pd.DataFrame:
        """reference: SNVprofile.get_clonality_table (524-548)."""
        clonT = self.get("clonT")
        if clonT is None:
            return pd.DataFrame()
        dbs = []
        for scaff, mm2series in clonT.items():
            for mm, series in mm2series.items():
                db = series.to_frame(name="clonality")
                db["mm"] = mm
                db = db.reset_index().rename(columns={"index": "position"})
                db["scaffold"] = scaff
                dbs.append(db)
        if not dbs:
            return pd.DataFrame()
        cdb = pd.concat(dbs).dropna().reset_index(drop=True)
        if nonredundant:
            cdb = (cdb.sort_values("mm").dropna()
                      .drop_duplicates(subset=["scaffold", "position"],
                                       keep="last")
                      .sort_index().drop(columns=["mm"]))
        return cdb

    def get_parsed_log(self) -> pd.DataFrame:
        from ..obs.logging import load_log
        return load_log(os.path.join(self.get_location("log"), "log.log"))

    # ---------- special (hd5) ----------

    def _store_special(self, name: str, obj) -> str:
        import h5py
        fileloc = self._fileloc(name) + ".hd5"
        if name in SPECIAL_SERIES:
            with h5py.File(fileloc, "w") as f:
                for scaff, mm2series in obj.items():
                    for mm, series in mm2series.items():
                        data = _special_pack(series)
                        # small datasets: contiguous beats chunk+filter
                        # overhead (see SpecialStreamWriter.write)
                        comp = _H5_COMP if data.size >= 8192 else None
                        f.create_dataset(f"{scaff}::{mm}", data=data,
                                         compression=comp,
                                         track_times=False)
        elif name in ("scaff2pair2mm2SNPs", "scaff2pair2mm2cov"):
            with h5py.File(fileloc, "w") as f:
                for scaff, pair2mm2 in obj.items():
                    for pair, mm2 in pair2mm2.items():
                        for mm, vals in mm2.items():
                            f.create_dataset(
                                f"{scaff}::{pair}::{mm}",
                                data=np.asarray(sorted(vals), dtype="float64"),
                                compression=_H5_COMP)
        else:
            fileloc = self._fileloc(name) + ".pickle"
            with open(fileloc, "wb") as f:
                pickle.dump(obj, f)
        return fileloc

    def _load_special(self, location: str, name: str, **kwargs):
        import h5py
        scaffolds = kwargs.get("scaffolds", [])
        if name in SPECIAL_SERIES or (name not in
                                      ("scaff2pair2mm2SNPs",
                                       "scaff2pair2mm2cov")):
            if location.endswith(".pickle"):
                with open(location, "rb") as f:
                    return pickle.load(f)
            scaff2mm = {}
            with h5py.File(location, "r") as f:
                for key in f.keys():
                    scaff, mm = key.split("::")
                    if scaffolds != [] and scaff not in scaffolds:
                        continue
                    dset = list(f[key])
                    scaff2mm.setdefault(scaff, {})[int(mm)] = pd.Series(
                        data=dset[0], index=np.array(dset[1]).astype(int))
            return scaff2mm
        # pair-keyed variant
        out: Dict = {}
        with h5py.File(location, "r") as f:
            for key in f.keys():
                scaff, pair, mm = key.split("::")
                if scaffolds != [] and scaff not in scaffolds:
                    continue
                out.setdefault(scaff, {}).setdefault(pair, {})[int(mm)] = \
                    set(np.array(f[key]).astype(int))
        return out

    def covt_scaffolds(self):
        """Scaffolds present in covT without loading it
        (reference: _get_covt_keys, SNVprofile.py:636-648)."""
        import h5py
        adb = self._get_attributes()
        filename = os.path.join(self.get_location("raw_data"),
                                os.path.basename(adb.loc["covT", "value"]))
        scaffs = set()
        with h5py.File(filename, "r") as f:
            for key in f.keys():
                scaffs.add(key.split("::")[0])
        return scaffs

    # ---------- internals ----------

    def _make_structure(self):
        for l in [""] + self.first_levels:
            loc = os.path.join(self.location, l)
            if not os.path.exists(loc):
                os.makedirs(loc)

    def _init_attributes(self):
        aloc = os.path.join(self.location, "raw_data/attributes.tsv")
        if not os.path.exists(aloc):
            adb = pd.DataFrame({"value": [], "type": [], "description": []})
            self._store_attributes(adb)
            self.store("location", self.location, "value",
                       "Location of SNVprofile object")
            self.store("version", _format_version(), "value",
                       "Version of inStrain")
            with open(self._fileloc("_README.txt"), "w") as f:
                f.write("Profile directory written by instrain_tpu "
                        f"{__version__} (inStrain-compatible format).\n")
        else:
            if self.location != self.get("location"):
                self.store("location", self.location, "value",
                           "Location of SNVprofile object")

    def _get_attributes(self) -> pd.DataFrame:
        aloc = os.path.join(self.location, "raw_data/attributes.tsv")
        return pd.read_csv(aloc, sep="\t", index_col="name")

    def _store_attributes(self, adb: pd.DataFrame):
        adb.to_csv(os.path.join(self.location, "raw_data/attributes.tsv"),
                   sep="\t", index_label="name")

    def _fileloc(self, name: str) -> str:
        return os.path.join(self.get_location("raw_data"), name)


def _format_version() -> str:
    """Versions the profile as the capability-matched inStrain version so
    reference tooling accepts the directory (same_versions checks
    major.minor; SNVprofile.py:863-873)."""
    from .. import __capability_version__
    return __capability_version__


class SpecialStreamWriter:
    """Write a 'special' hd5 attribute (one gzip'd dataset per
    "scaffold::mm" pair, reference SNVprofile.py:717-748 format) one
    scaffold at a time. Used by the batch engine's streaming consumer so
    covT/clonT/clonTR writes overlap the device launch loop instead of
    following it serially."""

    def __init__(self, isdir: ProfileDir, name: str, description: str):
        import h5py
        self._isdir = isdir
        self._name = name
        self._description = description
        self._loc = isdir._fileloc(name) + ".hd5"
        self._f = h5py.File(self._loc, "w")

    def write(self, scaffold: str, mm2series: dict):
        for mm, series in mm2series.items():
            data = _special_pack(series)
            # compression implies chunked storage; for the many small
            # per-(scaffold, mm) datasets of a fragmented assembly the
            # chunk + filter metadata dominates the write cost, so store
            # tiny datasets contiguous (reference readers don't care —
            # _load_special just slices f[key], SNVprofile.py:750-789).
            # track_times=False skips per-dataset mtime metadata.
            comp = _H5_COMP if data.size >= 8192 else None
            self._f.create_dataset(
                f"{scaffold}::{mm}", data=data, compression=comp,
                track_times=False)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
            self._isdir._register(self._name, self._loc, "special",
                                  self._description)

    def abort(self):
        if self._f is not None:
            self._f.close()
            self._f = None
