"""Speaker dataset over a corpus on disk: fragments, pair samplers, n-shot
tasks, and the export to an :class:`AudioStore`.

Port of ``voicemap_tpu/data/dataset.py`` without pandas. The rows are an
``index.Index`` in the JAX package's order, and every host draw is the JAX
class's: ``np.random.default_rng(seed)`` called with the same arguments in
the same order, so the same seed gives the same fragments, batches, pairs
and tasks (``tests/test_torch_data_layer.py`` holds them equal). The
orders that matter:

- files shorter than the fragment are dropped (unless ``pad``) before the
  ids are renumbered;
- ``unique_speakers`` is sorted, but the pair and task samplers draw from
  the speakers with enough utterances in order of first appearance, as
  pandas' ``groupby(...).filter(...).speaker_id.unique()`` lists them, and
  from each speaker's ids in row order.

``to_store`` decodes everything into the port's ``data/store.AudioStore``
(the same five arrays), which ``train/steps.DeviceStore`` ships to the card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DATA_PATH, DataConfig
from . import audio, index as index_mod
from .store import AudioStore

# The share of the memory of the device that the store goes to above which
# fit(pipeline="auto") streams from disk instead. The JAX package's 4 GiB was
# 25% of a 16 GB v5e's memory; on the card the share is kept: the largest
# train step the auto policies run at B=2048, config #4's, peaks at 41.1 GB
# of the H100's 80 (config #3's at 37.1, config #1's at 22-26; PERF.md §5),
# which leaves 39 GB, room for a store of a quarter of the card (20 GB) and
# its decimated copy made while it ships (a quarter more at downsampling 4).
# ``fit(streaming_threshold_bytes=...)`` overrides it.
STREAMING_THRESHOLD_SHARE = 0.25


def streaming_threshold_bytes(device) -> int:
    """``STREAMING_THRESHOLD_SHARE`` of the memory of ``device`` (the card's
    total memory, or the host's for the CPU)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(STREAMING_THRESHOLD_SHARE * total)


class SpeakerDataset:
    """A LibriSpeech-shaped corpus as speaker-labelled fragments.

    ``label`` is ``"speaker"`` or ``"sex"``; ``stochastic`` draws fragment
    offsets at random (else offset 0); ``pad`` zero-pads files shorter than
    the fragment (else they are dropped).
    """

    def __init__(self, subsets: Sequence[str], seconds: float, label: str = "speaker",
                 stochastic: bool = True, pad: bool = False, data_root: Optional[str] = None,
                 use_cache: bool = True, seed: int = 0, sample_rate: int = 16000):
        if label not in ("speaker", "sex"):
            raise ValueError("label must be 'speaker' or 'sex'")
        if isinstance(subsets, str):
            subsets = (subsets,)
        self.subsets = tuple(subsets)
        self.seconds = float(seconds)
        self.sample_rate = int(sample_rate)
        self.fragment_length = int(self.seconds * self.sample_rate)
        self.label = label
        self.stochastic = stochastic
        self.pad = pad
        self.data_root = data_root or DATA_PATH
        self.rng = np.random.default_rng(seed)

        idx = index_mod.load_index(self.data_root, self.subsets, use_cache=use_cache)
        if not pad:
            idx = idx.take(idx.samples >= self.fragment_length)
        idx = idx.renumbered()
        if len(idx) == 0:
            raise ValueError("no files long enough for requested fragment length")
        self.index = idx

        self.datasetid_to_filepath: Dict[int, str] = dict(zip(idx.id.tolist(), idx.filepath))
        self.datasetid_to_speaker_id: Dict[int, int] = dict(
            zip(idx.id.tolist(), idx.speaker_id.tolist()))
        self.datasetid_to_sex: Dict[int, str] = dict(zip(idx.id.tolist(), idx.sex))
        self.sex_to_label = {"M": 0, "F": 1}
        self.unique_speakers = sorted(np.unique(idx.speaker_id).tolist())
        self.num_classes_ = len(self.unique_speakers) if label == "speaker" else 2
        self.speaker_id_mapping = {s: i for i, s in enumerate(self.unique_speakers)}
        self._decode_cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.index)

    def num_classes(self) -> int:
        return self.num_classes_

    def path_of(self, dataset_id: int) -> str:
        """The file of ``dataset_id`` (index paths are relative to the data root)."""
        path = self.datasetid_to_filepath[dataset_id]
        return path if os.path.isabs(path) else os.path.join(self.data_root, path)

    def _decode(self, dataset_id: int) -> np.ndarray:
        wav = self._decode_cache.get(dataset_id)
        if wav is None:
            full = self.path_of(dataset_id)
            wav, sr = audio.read(full)
            if sr != self.sample_rate:
                raise ValueError(f"{full}: sample rate {sr} != {self.sample_rate}")
            self._decode_cache[dataset_id] = wav
        return wav

    def __getitem__(self, dataset_id: int) -> Tuple[np.ndarray, int]:
        """One fragment → (float32 (fragment_length, 1), label): a random
        start when stochastic, else the start of the file; a short file
        (``pad``) zero-padded, at a random split when stochastic."""
        wav = audio.to_float(self._decode(dataset_id))
        T = self.fragment_length
        if len(wav) >= T:
            start = int(self.rng.integers(0, len(wav) - T + 1)) if self.stochastic else 0
            frag = wav[start: start + T]
        elif self.pad:
            deficit = T - len(wav)
            before = int(self.rng.integers(0, deficit + 1)) if self.stochastic else 0
            frag = np.pad(wav, (before, deficit - before))
        else:
            raise ValueError(f"file {dataset_id} shorter than fragment and pad=False")
        return frag[:, None].astype(np.float32), self._label_of(dataset_id)

    def _label_of(self, dataset_id: int) -> int:
        if self.label == "speaker":
            return self.datasetid_to_speaker_id[dataset_id]
        return self.sex_to_label[self.datasetid_to_sex[dataset_id]]

    def _eligible(self, min_utts: int) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
        """The speakers with at least ``min_utts`` rows in order of first
        appearance, and each one's ids in row order."""
        spk = self.index.speaker_id
        uniq, first, counts = np.unique(spk, return_index=True, return_counts=True)
        keep = counts >= min_utts
        speakers = uniq[keep][np.argsort(first[keep], kind="stable")]
        ids = {int(s): self.index.id[spk == s] for s in speakers}
        return speakers, ids

    def get_alike_pairs(self, num: int) -> List[Tuple[int, int]]:
        """``num`` pairs of distinct dataset ids sharing a speaker."""
        speakers, ids = self._eligible(2)
        chosen = self.rng.choice(speakers, size=num, replace=True)
        pairs = []
        for s in chosen:
            a, b = self.rng.choice(ids[int(s)], size=2, replace=False)
            pairs.append((int(a), int(b)))
        return pairs

    def get_differing_pairs(self, num: int) -> List[Tuple[int, int]]:
        """``num`` pairs of dataset ids with different speakers."""
        pairs = []
        ids, spk = self.index.id, self.index.speaker_id
        for _ in range(num):
            while True:
                a, b = self.rng.choice(len(ids), size=2, replace=False)
                if spk[a] != spk[b]:
                    pairs.append((int(ids[a]), int(ids[b])))
                    break
        return pairs

    def build_verification_batch(self, batchsize: int, same_label: int = 0
                                 ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Half alike, half differing pairs → ([x1, x2], labels): ``same_label``
        for the alike pairs, ``1 − same_label`` for the differing ones."""
        half = batchsize // 2
        alike = self.get_alike_pairs(half)
        differ = self.get_differing_pairs(batchsize - half)
        x1, x2, y = [], [], []
        for pairs, lab in ((alike, same_label), (differ, 1 - same_label)):
            for a, b in pairs:
                x1.append(self[a][0])
                x2.append(self[b][0])
                y.append(lab)
        return [np.stack(x1), np.stack(x2)], np.asarray(y, dtype=np.float32)

    def build_classifier_batch(self, batchsize: int) -> Tuple[np.ndarray, np.ndarray]:
        """Uniformly drawn utterances → (instances, contiguous class labels)."""
        ids = self.rng.choice(self.index.id, size=batchsize, replace=True)
        xs, ys = [], []
        for i in ids:
            x, lab = self[int(i)]
            xs.append(x)
            ys.append(self.speaker_id_mapping[lab] if self.label == "speaker" else lab)
        return np.stack(xs), np.asarray(ys, dtype=np.int32)

    def build_n_shot_task(self, k: int, n: int = 1
                          ) -> Tuple[Tuple[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]:
        """A 1-query, k-way, n-shot task whose query's speaker is support
        class 0 → ((query (T, 1), its speaker), (support (k·n, T, 1),
        speakers (k·n,)))."""
        speakers, ids = self._eligible(n + 1)
        if len(speakers) < k:
            raise ValueError(f"need ≥{k} speakers with ≥{n + 1} utterances")
        chosen = self.rng.choice(speakers, size=k, replace=False)
        picks = self.rng.choice(ids[int(chosen[0])], size=n + 1, replace=False)
        query = self[int(picks[0])][0]
        support_x, support_y = [], []
        for ci, s in enumerate(chosen):
            sel = picks[1:] if ci == 0 else self.rng.choice(ids[int(s)], size=n, replace=False)
            for i in sel:
                support_x.append(self[int(i)][0])
                support_y.append(s)
        return (query, int(chosen[0])), (np.stack(support_x), np.asarray(support_y))

    def to_store(self, max_seconds: Optional[float] = None) -> AudioStore:
        """Decode everything into padded arrays for the device pipeline; a
        file longer than ``max_seconds`` is cut to it."""
        idx = self.index
        T_cap = (int(max_seconds * self.sample_rate) if max_seconds is not None
                 else int(idx.samples.max()))
        N = len(idx)
        lengths = np.minimum(idx.samples, T_cap).astype(np.int32)
        T_store = int(lengths.max())
        store = np.zeros((N, T_store), dtype=np.int16)
        for i in idx.id:
            wav = self._decode(int(i))[:T_store]
            store[i, : len(wav)] = wav
        if self.label == "speaker":
            labels = np.asarray([self.speaker_id_mapping[s] for s in idx.speaker_id.tolist()],
                                dtype=np.int32)
            label_names = list(self.unique_speakers)
        else:
            labels = np.asarray([self.sex_to_label[s] for s in idx.sex], dtype=np.int32)
            label_names = ["M", "F"]
        # Grouped by speaker in either label mode: pairs and tasks are by speaker.
        groups = [idx.id[idx.speaker_id == s] for s in self.unique_speakers]
        max_utt = max(len(g) for g in groups)
        speaker_utts = np.zeros((len(groups), max_utt), dtype=np.int32)
        speaker_counts = np.zeros(len(groups), dtype=np.int32)
        for gi, g in enumerate(groups):
            speaker_utts[gi, : len(g)] = g
            speaker_counts[gi] = len(g)
        return AudioStore(audio=store, lengths=lengths, labels=labels,
                          speaker_utts=speaker_utts, speaker_counts=speaker_counts,
                          sample_rate=self.sample_rate, label_names=label_names)


def estimate_store_bytes(ds: SpeakerDataset, max_seconds, sample_rate) -> int:
    """The int16 footprint of ``ds.to_store(max_seconds)``: N × the longest
    capped utterance × 2 bytes (``to_store`` pads to the longest)."""
    cap = max_seconds or float(ds.index.seconds.max())
    t_store = int(np.minimum(ds.index.samples, cap * sample_rate).max())
    return t_store * len(ds.index) * 2


def dataset_from_config(cfg: DataConfig, **kw) -> SpeakerDataset:
    return SpeakerDataset(subsets=cfg.subsets, seconds=cfg.seconds, label=cfg.label,
                          stochastic=cfg.stochastic, pad=cfg.pad, data_root=cfg.data_root,
                          use_cache=cfg.use_cache, sample_rate=cfg.sample_rate, **kw)
