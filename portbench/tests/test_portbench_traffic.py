"""The generator: the same seed makes the same inputs and weights, another
seed other ones over the same set of lengths."""

from __future__ import annotations

import torch

from portbench import data

SPEC = data.StoreSpec(speakers=5, utterances=1100, min_seconds=0.2, max_seconds=0.5)
CONFIG = {"encoder": {"filters": 8, "embedding_dim": 4, "filter_multipliers": [1, 2],
                      "kernel_sizes": [32, 3], "pool_sizes": [4, 2], "dilations": [1, 1]},
          "data": {"whiten_rms": 0.038021, "seconds": 0.25, "sample_rate": 16000, "downsampling": 4}}
SEEDS = (2**31 + 11, 7)


def test_lengths_are_one_set_in_another_order():
    a, b = (data.lengths(SPEC, s) for s in SEEDS)
    assert torch.equal(a, data.lengths(SPEC, SEEDS[0]))
    assert not torch.equal(a, b)
    assert torch.equal(a.sort().values, b.sort().values)
    assert int(a.min()) >= 0.2 * 16000 and int(a.max()) <= 0.5 * 16000


def test_labels_cover_every_utterance():
    counts = data.speaker_counts(SPEC)
    assert int(counts.sum()) == SPEC.utterances and int(counts.max() - counts.min()) <= 1
    assert torch.equal(torch.bincount(data.labels(SPEC)), counts)


def test_rows_repeat_and_can_be_made_alone():
    chunk = data.raw_chunk(SPEC, SEEDS[0], 1, "cpu")
    assert torch.equal(chunk, data.raw_chunk(SPEC, SEEDS[0], 1, "cpu"))
    assert not torch.equal(chunk, data.raw_chunk(SPEC, SEEDS[1], 1, "cpu"))
    n = data.lengths(SPEC, SEEDS[0])[data.CHUNK + 3]
    assert torch.all(chunk[3, n:] == 0) and torch.any(chunk[3, :n] != 0)
    rows, starts = torch.tensor([data.CHUNK + 3, 2]), torch.tensor([5, 0])
    got = data.raw_windows(SPEC, SEEDS[0], rows, starts, 100, "cpu")
    assert torch.equal(got[0], chunk[3, 5:105])
    assert torch.equal(got[1], data.raw_chunk(SPEC, SEEDS[0], 0, "cpu")[2, :100])


def test_query_pool_and_weights_repeat():
    qa, sa = data.query_pool(SPEC, SEEDS[0], 6, 0.25, "cpu")
    qb, sb = data.query_pool(SPEC, SEEDS[0], 6, 0.25, "cpu")
    assert torch.equal(qa, qb) and torch.equal(sa, sb) and qa.shape == (6, 4000)
    wa, wb = (data.weights(CONFIG, 3, s, "cpu") for s in SEEDS)
    again = data.weights(CONFIG, 3, SEEDS[0], "cpu")
    assert all(torch.equal(wa[n], again[n]) for n in wa)
    assert not torch.equal(wa["blocks.1.w"], wb["blocks.1.w"])
    assert wa["blocks.1.w"].shape == (16, 8, 3) and wa["head.w"].shape == (3, 4)
    assert torch.all(wa["blocks.0.var"] > 0)
