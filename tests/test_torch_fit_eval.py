"""``fit`` evaluates on the reference's embedding path, on the CPU.

The JAX ``fit`` calls ``nshot.evaluate`` with ``fast`` left at False
(``voicemap_tpu/train/loop.py``), so its table comes from the model's own
forward, whatever the step trains through. The port's ``fit`` does the same:
with the block-0 train kernel's policy on (the card's default), the recorded
``val_{n}-shot_acc`` is exactly ``evaluate(..., fast=False)`` of the final
model on the same generator seed, and ``evaluate`` is never asked for the
fused path. Classifier (config #1) and siamese (config #2) mode, bf16, where
the fused and unfused tables round at other places.
"""

import pytest
import torch

from voicemap_tpu_torch.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.train.loop import fit
from voicemap_tpu_torch.train.steps import device_store_for

STEPS = 4


def config(mode):
    siamese = dict(mode="siamese", siamese=SiameseConfig(distance_metric="weighted_l1"))
    return ExperimentConfig(
        data=DataConfig(seconds=0.1, downsampling=4),
        encoder=EncoderConfig(filters=16, embedding_dim=8, dropout=0.0),
        train=TrainConfig(batch_size=8, num_steps=STEPS, evaluate_every=2, num_eval_tasks=64,
                          use_fused_block0=True, use_fused_blockn=True, seed=3),
        **(siamese if mode == "siamese" else {}))


@pytest.mark.parametrize("mode", ["classifier", "siamese"])
def test_fit_records_the_unfused_evaluation(monkeypatch, mode):
    cfg = config(mode)
    store = synthetic_store(5, n_speakers=6, utterances_per_speaker=4, min_seconds=0.2,
                            max_seconds=0.3)
    asked = []
    real = nshot.evaluate

    def recorded(*args, **kw):
        asked.append(kw.get("fast", False))
        return real(*args, **kw)

    monkeypatch.setattr(nshot, "evaluate", recorded)
    with pytest.warns(UserWarning, match="TRAINING store"):
        state, history = fit(cfg, store, device="cpu", verbose=False)
    assert asked == [False, False]  # one evaluation at step 2, one at step 4
    model = state.model.eval()
    dstore = device_store_for(cfg, store, "cpu")
    t = cfg.train
    gen = torch.Generator().manual_seed(t.seed + 1 + (STEPS - 1))  # fit's generator at the end
    want = real(model, dstore, cfg, gen, num_tasks=t.num_eval_tasks, n=t.n_shot, k=t.k_way,
                fast=False)
    assert history[-1]["val_1-shot_acc"] == want
    # The fused table is another one: in bf16 it rounds block 0 at other places.
    fused = nshot.embed_all(model, dstore, cfg, fast=True)
    assert not torch.equal(fused, nshot.embed_all(model, dstore, cfg, fast=False))
