"""The streaming host pipeline: corpora read from disk batch by batch.

Port of ``voicemap_tpu/data/pipeline.py``. The device pipeline
(``train/steps.DeviceStore``) holds the whole int16 corpus on the card; for a
corpus larger than that, this module streams:

    sampler (numpy, seeded) → decode (C++ FLAC threads, bounded LRU cache)
      → fragments cut on the host (B, frag) int16 → bounded queue → the step

One producer thread fills a bounded queue while the card runs the step; the
FLAC decoder's own threads decode a batch with the GIL released. Sampling is
one seeded ``np.random.default_rng`` stream, drawn in the JAX package's
order, so the same seed gives the same batches as its pipeline
(``tests/test_torch_streaming.py``). A producer's error is raised on the
consumer's side; ``close()`` stops and joins the thread.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import ExperimentConfig
from . import audio
from .dataset import SpeakerDataset


class DecodeCache:
    """Bounded LRU cache of decoded int16 waveforms, keyed by dataset id."""

    def __init__(self, dataset: SpeakerDataset, max_bytes: int = 2 << 30):
        self.dataset = dataset
        self.max_bytes = max_bytes
        self._cache: "collections.OrderedDict[int, np.ndarray]" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get_many(self, ids: np.ndarray) -> list:
        """The waveforms of ``ids``, in order. Misses are decoded in one
        threaded batch when every missing file is FLAC (and more than one),
        else one by one."""
        out = [None] * len(ids)
        missing = []
        with self._lock:
            for i, did in enumerate(ids):
                wav = self._cache.get(int(did))
                if wav is not None:
                    self._cache.move_to_end(int(did))
                    out[i] = wav
                else:
                    missing.append(i)
        if missing:
            paths = [self.dataset.path_of(int(ids[i])) for i in missing]
            if len(paths) > 1 and all(p.lower().endswith(".flac") for p in paths):
                from . import flac_ext

                decoded = flac_ext.read_batch(paths)
            else:
                decoded = [audio.read(p)[0] for p in paths]
            with self._lock:
                for i, wav in zip(missing, decoded):
                    did = int(ids[i])
                    out[i] = wav
                    if did not in self._cache:
                        self._cache[did] = wav
                        self._bytes += wav.nbytes
                while self._bytes > self.max_bytes and self._cache:
                    _, old = self._cache.popitem(last=False)
                    self._bytes -= old.nbytes
        return out


Batch = Tuple[np.ndarray, ...]


def _cut_deterministic(wavs: list, frag: int, pad: bool) -> np.ndarray:
    """Offset-0 fragments (``stochastic=False``, the evaluation's)."""
    out = np.zeros((len(wavs), frag), dtype=np.int16)
    for i, wav in enumerate(wavs):
        if len(wav) >= frag:
            out[i] = wav[:frag]
        elif pad:
            out[i, : len(wav)] = wav
        else:
            raise ValueError(f"file shorter than fragment ({len(wav)} < {frag}) with "
                             "pad=False; enable DataConfig.pad or drop short files")
    return out


def _put(q: "queue.Queue", item, stop: threading.Event) -> None:
    """A bounded put that gives up once ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return
        except queue.Full:
            continue


def _drain(q: "queue.Queue") -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def iter_embed_batches(dataset: SpeakerDataset, cfg: ExperimentConfig, batch_size: int,
                       depth: int = 2, cache_bytes: int = 1 << 30
                       ) -> Iterator[Tuple[np.ndarray, int]]:
    """Offset-0 fragment batches in dataset-id order, for streaming embedding.

    Yields ``(frags (batch_size, frag) int16, valid_count)``; the rows are in
    store-row order, so a table built from them aligns row for row with the
    device store's; the last batch is zero-padded past ``valid_count``. A
    producer thread decodes ahead of the consumer.
    """
    frag = cfg.data.fragment_length
    ids = np.asarray(dataset.index.id)
    cache = DecodeCache(dataset, cache_bytes)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        try:
            for s in range(0, len(ids), batch_size):
                if stop.is_set():
                    return
                chunk = ids[s: s + batch_size]
                frags = _cut_deterministic(cache.get_many(chunk), frag, cfg.data.pad)
                if len(chunk) < batch_size:
                    padded = np.zeros((batch_size, frag), np.int16)
                    padded[: len(chunk)] = frags
                    frags = padded
                _put(q, (frags, len(chunk)), stop)
            q.put(None)
        except BaseException as e:  # raised on the consumer's side
            q.put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("streaming embed producer failed") from item
            yield item
    finally:
        # An abandoned generator releases its producer: stop, drain so that a
        # blocked put wakes, join.
        stop.set()
        _drain(q)
        thread.join(timeout=5)


class StreamingPipeline:
    """A producer thread that yields ready int16 batches.

    ``mode``: ``"classifier"`` → (fragments (B, frag) int16, labels (B,)
    int32); ``"siamese"`` → (frag1, frag2, labels float32), half alike and
    half differing pairs as ``SpeakerDataset.build_verification_batch`` lays
    them out. Fragments are cut on the host at any sample offset; decimation
    and whitening are left to the device (``train/steps.preprocess_fragments``).
    """

    def __init__(self, dataset: SpeakerDataset, cfg: ExperimentConfig,
                 mode: str = "classifier", depth: int = 3, seed: int = 0,
                 cache_bytes: int = 2 << 30):
        self.dataset = dataset
        self.cfg = cfg
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.cache = DecodeCache(dataset, cache_bytes)
        self.frag = cfg.data.fragment_length
        self.B = cfg.train.batch_size
        self._q: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _cut(self, wavs: list) -> np.ndarray:
        if not self.cfg.data.stochastic:
            return _cut_deterministic(wavs, self.frag, self.cfg.data.pad)
        out = np.zeros((len(wavs), self.frag), dtype=np.int16)
        for i, wav in enumerate(wavs):
            if len(wav) >= self.frag:
                start = int(self.rng.integers(0, len(wav) - self.frag + 1))
                out[i] = wav[start: start + self.frag]
            elif self.cfg.data.pad:
                out[i, : len(wav)] = wav
            else:
                raise ValueError(
                    f"file shorter than fragment ({len(wav)} < {self.frag}) "
                    "with pad=False; enable DataConfig.pad or drop short files")
        return out

    def _classifier_batch(self) -> Batch:
        ds = self.dataset
        ids = self.rng.choice(ds.index.id, size=self.B)
        wavs = self.cache.get_many(ids)
        labels = np.asarray(
            [ds.speaker_id_mapping[ds.datasetid_to_speaker_id[int(i)]]
             if ds.label == "speaker" else ds.sex_to_label[ds.datasetid_to_sex[int(i)]]
             for i in ids], dtype=np.int32)
        return self._cut(wavs), labels

    def _siamese_batch(self) -> Batch:
        half = self.B // 2
        # The dataset's pair samplers, drawing from this pipeline's stream.
        self.dataset.rng = self.rng
        pairs = self.dataset.get_alike_pairs(half) + self.dataset.get_differing_pairs(
            self.B - half)
        w1 = self.cache.get_many(np.asarray([a for a, _ in pairs]))
        w2 = self.cache.get_many(np.asarray([b for _, b in pairs]))
        same = float(self.cfg.siamese.same_label)
        labels = np.concatenate([np.full(half, same, np.float32),
                                 np.full(self.B - half, 1.0 - same, np.float32)])
        return self._cut(w1), self._cut(w2), labels

    def _produce(self):
        try:
            while not self._stop.is_set():
                _put(self._q, self._classifier_batch() if self.mode == "classifier"
                     else self._siamese_batch(), self._stop)
        except BaseException as e:  # raised on the consumer's side
            self._exc = e
            self._q.put(None)

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        item = self._q.get()
        if item is None:
            raise RuntimeError("streaming producer failed") from self._exc
        return item

    @property
    def closed(self) -> bool:
        """True once the producer thread has ended."""
        return not self._thread.is_alive()

    def close(self):
        self._stop.set()
        _drain(self._q)
        self._thread.join(timeout=5)
