"""The corpus index and its CSV cache, without pandas.

Port of ``voicemap_tpu/data/index.py``: walk ``<root>/LibriSpeech/<subset>``
for audio files, join each speaker's sex from ``SPEAKERS.TXT``, probe each
file's length, and cache the rows as ``<root>/<subset>.index.csv`` so that
the probe loop is paid once. The JAX package keeps the rows in a pandas
DataFrame; here they are an :class:`Index`, one numpy array a column, in the
same row order. The cache is the same file with the same columns in the same
order (``filepath,speaker_id,sex,samples,sample_rate,seconds``), read and
written with the ``csv`` module: ``seconds`` is written as ``repr`` of the
float, as pandas' ``to_csv`` writes it, so a cache written by either package
reads in the other to the same rows and types.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from . import audio

AUDIO_EXTS = (".flac", ".wav")
CSV_COLUMNS = ("filepath", "speaker_id", "sex", "samples", "sample_rate", "seconds")
_INT_COLUMNS = ("speaker_id", "samples", "sample_rate")


@dataclass
class Index:
    """Index rows as columns: ``filepath`` (relative to the data root) and
    ``sex`` are object arrays of str, ``speaker_id``, ``samples``,
    ``sample_rate`` and ``id`` int64, ``seconds`` float64, ``subset`` str.
    ``id`` numbers the rows 0..N-1 (the dataset id)."""

    filepath: np.ndarray
    speaker_id: np.ndarray
    sex: np.ndarray
    samples: np.ndarray
    sample_rate: np.ndarray
    seconds: np.ndarray
    subset: np.ndarray
    id: np.ndarray

    def __len__(self) -> int:
        return len(self.id)

    def take(self, rows) -> "Index":
        """The rows selected by a boolean mask or an index array, in order."""
        return Index(**{f.name: getattr(self, f.name)[rows] for f in dataclasses.fields(self)})

    def renumbered(self) -> "Index":
        """The same rows with ``id`` = 0..N-1."""
        return dataclasses.replace(self, id=np.arange(len(self), dtype=np.int64))

    @classmethod
    def from_rows(cls, rows: List[Dict], subset: str = "") -> "Index":
        """Rows of the CSV columns → an Index of one subset (ids 0..N-1)."""
        def col(k, dtype):
            return np.asarray([r[k] for r in rows], dtype=dtype)

        return cls(filepath=col("filepath", object),
                   speaker_id=col("speaker_id", np.int64), sex=col("sex", object),
                   samples=col("samples", np.int64), sample_rate=col("sample_rate", np.int64),
                   seconds=col("seconds", np.float64),
                   subset=np.full(len(rows), subset, dtype=object),
                   id=np.arange(len(rows), dtype=np.int64))

    @classmethod
    def concat(cls, parts: Sequence["Index"]) -> "Index":
        """Rows of ``parts`` one after another, renumbered."""
        out = cls(**{f.name: np.concatenate([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(cls)})
        return out.renumbered()


def read_speakers_txt(path: str) -> List[Dict]:
    """Parse LibriSpeech's SPEAKERS.TXT (';' comment lines, '|'-delimited)
    → one dict a speaker: speaker_id, sex, subset, minutes, name."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith(";") or not line.strip():
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) < 5:
                continue
            rows.append({"speaker_id": int(parts[0]), "sex": parts[1], "subset": parts[2],
                         "minutes": float(parts[3]), "name": "|".join(parts[4:])})
    return rows


def subset_available(data_root: str, subset: str) -> bool:
    """True when the subset can be indexed: its directory exists under
    ``<root>/LibriSpeech/`` or its cached index CSV does."""
    return (os.path.isdir(os.path.join(data_root, "LibriSpeech", subset))
            or os.path.isfile(os.path.join(data_root, f"{subset}.index.csv")))


def index_subset(data_root: str, subset: str) -> Index:
    """Walk one subset's tree and probe every audio file (headers only), in
    the JAX package's order: directories sorted by path, files by name."""
    ls_root = os.path.join(data_root, "LibriSpeech")
    sex_map = {r["speaker_id"]: r["sex"]
               for r in read_speakers_txt(os.path.join(ls_root, "SPEAKERS.TXT"))}
    subset_dir = os.path.join(ls_root, subset)
    if not os.path.isdir(subset_dir):
        raise FileNotFoundError(f"subset directory not found: {subset_dir}")
    rows = []
    for dirpath, _dirnames, filenames in sorted(os.walk(subset_dir)):
        for fname in sorted(filenames):
            if not fname.lower().endswith(AUDIO_EXTS):
                continue
            fpath = os.path.join(dirpath, fname)
            speaker_id = int(fname.split("-")[0])
            n_samples, sr = audio.probe(fpath)
            rows.append({"filepath": os.path.relpath(fpath, data_root),
                         "speaker_id": speaker_id, "sex": sex_map.get(speaker_id, "?"),
                         "samples": n_samples, "sample_rate": sr, "seconds": n_samples / sr})
    if not rows:
        raise FileNotFoundError(f"no audio files under {subset_dir}")
    return Index.from_rows(rows, subset)


def write_index_csv(path: str, index: Index) -> None:
    """The cache file, as pandas' ``to_csv(index=False)`` writes it."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(CSV_COLUMNS)
        for row in zip(index.filepath, index.speaker_id, index.sex, index.samples,
                       index.sample_rate, index.seconds):
            w.writerow([*row[:5], repr(float(row[5]))])


def read_index_csv(path: str, subset: str = "") -> Index:
    """A cache file written by either package → its rows."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = [{**r, **{k: int(r[k]) for k in _INT_COLUMNS}, "seconds": float(r["seconds"])}
                for r in reader]
    return Index.from_rows(rows, subset)


def load_index(data_root: str, subsets: Sequence[str], use_cache: bool = True) -> Index:
    """The rows of ``subsets``, one after another, ids 0..N-1: from each
    subset's cache ``<root>/<subset>.index.csv`` when it exists, else indexed
    and (with ``use_cache``) cached."""
    parts = []
    for subset in subsets:
        cache_path = os.path.join(data_root, f"{subset}.index.csv")
        if use_cache and os.path.exists(cache_path):
            part = read_index_csv(cache_path, subset)
        else:
            part = index_subset(data_root, subset)
            if use_cache:
                os.makedirs(data_root, exist_ok=True)
                write_index_csv(cache_path, part)
        parts.append(part)
    return Index.concat(parts)
