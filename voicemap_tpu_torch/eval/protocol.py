"""The frozen eval protocol (``EVAL_PROTOCOL.json``) on the port.

Port of ``voicemap_tpu/eval/protocol.py``: load the manifest, check that the
corpus is the one it pins (speaker and utterance counts, an index
fingerprint), run every pinned entry with the pinned seeds and fragment
settings, and return one JSON-ready record an entry, with the manifest's
acceptance rule's standard errors and intervals. ``int8_accuracy_gate``
runs every entry in full precision and through the int8 serving path and
applies that rule to each pair.

The manifest pins the tasks to ``jax.random.PRNGKey(task_seed)`` and the
pairs to ``PRNGKey(pair_seed)``, drawn as the JAX samplers draw them. Here
they come from ``ops/jax_random``, which replays that stream in numpy, so
the records score the very tasks and pairs of the JAX package's, and each
carries ``"key_stream"`` to say so (the one field the JAX records lack).
The manifest is a data file at the repository's root, read as JSON; it is
the same file the JAX package reads.

The records are the JAX package's with ``model`` (a port model on its
device) in place of ``(model, state)``: the stores are built on the model's
device, and the caches key model-dependent entries by ``id(model)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

from ..data import dataset as dataset_mod
from ..models.quant_infer import quantize_from_store
from ..ops import jax_random
from ..train import steps as steps_mod
from . import nshot
from . import verification as V

MANIFEST_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "EVAL_PROTOCOL.json",
)


def load_manifest(path: Optional[str] = None) -> Dict:
    with open(path or MANIFEST_PATH) as f:
        return json.load(f)


def corpus_fingerprint(ds_or_index) -> str:
    """sha256 over the sorted ``<relpath>|<speaker_id>|<seconds:.3f>`` lines
    of a dataset's index (or of a bare ``data/index.Index``, a per-subset
    view), each line ended by a newline: the JAX package's digest of the
    same rows."""
    idx = getattr(ds_or_index, "index", ds_or_index)
    lines = sorted(f"{fp}|{int(spk)}|{float(sec):.3f}"
                   for fp, spk, sec in zip(idx.filepath, idx.speaker_id, idx.seconds))
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def _subset_frame(ds, subset: str):
    """The rows of ``ds.index`` of one subset (a dataset of several subsets
    is checked subset by subset): by the index's ``subset`` column where it
    is filled in, else by the data-root-relative path prefix
    ``LibriSpeech/<subset>/``."""
    idx = ds.index
    if len(idx) and all(idx.subset):
        return idx.take(idx.subset == subset)
    return idx.take(np.asarray([fp.startswith(f"LibriSpeech/{subset}/")
                                for fp in idx.filepath], dtype=bool))


def check_corpus(ds, subset: str, manifest: Dict,
                 fingerprints: Optional[Dict[str, str]] = None) -> List[str]:
    """Mismatches between the dataset's ``subset`` rows and the manifest's
    pinned identity (empty: verified; a null fingerprint is taken on trust).
    ``fingerprints``: a cache, filled with each subset's fingerprint as it is
    computed."""
    ident = manifest["corpus_identity"].get(subset)
    if ident is None:
        return [f"subset {subset} not pinned in the manifest"]
    problems = []
    idx = _subset_frame(ds, subset)
    n_spk = len(np.unique(idx.speaker_id))
    n_utt = len(idx)
    if n_spk != ident["n_speakers"]:
        problems.append(f"{subset}: {n_spk} speakers, manifest pins {ident['n_speakers']}")
    if n_utt != ident["n_utterances"]:
        problems.append(f"{subset}: {n_utt} utterances, manifest pins {ident['n_utterances']}")
    if ident.get("fingerprint"):
        fp = (fingerprints or {}).get(subset)
        if fp is None:
            fp = corpus_fingerprint(idx)
            if fingerprints is not None:
                fingerprints[subset] = fp
        if fp != ident["fingerprint"]:
            problems.append(f"{subset}: index fingerprint {fp[:16]}… != pinned")
    return problems


def _model_device(model):
    return next(model.parameters()).device


def _entry_store(cfg_base, data_root: str, subsets, manifest: Dict,
                 allow_corpus_mismatch: bool, max_store_seconds: Optional[float],
                 device, cache: Optional[Dict] = None):
    """``(cfg, ds, store, problems, fps)`` for one entry's subsets, its
    fragment settings the manifest's. ``cache`` (keyed by the subsets tuple)
    shares the decode and the store on the device between the passes of a
    protocol run."""
    key = tuple(subsets)
    if cache is not None and key in cache:
        return cache[key]
    frag = manifest["fragment"]
    data_cfg = dataclasses.replace(
        cfg_base.data, data_root=data_root, subsets=key, seconds=frag["seconds"],
        sample_rate=frag["sample_rate"], downsampling=frag["downsampling"],
        stochastic=frag["stochastic"], pad=frag["pad"], whiten_rms=frag["whiten_rms"])
    cfg = cfg_base.replace(data=data_cfg)
    ds = dataset_mod.dataset_from_config(cfg.data)
    problems: List[str] = []
    fps: Dict[str, str] = {}
    for subset in key:
        problems += check_corpus(ds, subset, manifest, fingerprints=fps)
    if problems and not allow_corpus_mismatch:
        raise ValueError("corpus does not match EVAL_PROTOCOL.json: " + "; ".join(problems))
    store = steps_mod.device_store_for(cfg, ds.to_store(max_store_seconds), device)
    out = (cfg, ds, store, problems, fps)
    if cache is not None:
        cache[key] = out
    return out


def _entry_qvars(model, cfg, store, subsets, cache: Optional[Dict]):
    """The int8 qvars calibrated on one entry's store, shared between passes
    through ``cache`` (keyed ``('qvars', id(model), *subsets)``)."""
    key = ("qvars", id(model)) + tuple(subsets)
    if cache is not None and key in cache:
        return cache[key]
    qvars = quantize_from_store(model, cfg, store)
    if cache is not None:
        cache[key] = qvars
    return qvars


def _entry_table(model, cfg, store, subsets, fast, qvars, cache: Optional[Dict]):
    """The embedding table of one entry's store, shared between the accuracy
    and verification passes (fragments are deterministic, so the table is
    the same), keyed ``('table', id(model), int8?, fast?, *subsets)``."""
    key = ("table", id(model), qvars is not None, bool(fast)) + tuple(subsets)
    if cache is not None and key in cache:
        return cache[key]
    table = nshot.embed_all(model, store, cfg, fast=fast, qvars=qvars)
    if cache is not None:
        cache[key] = table
    return table


def _entry_fingerprint(ds, subsets, fps: Dict[str, str]) -> str:
    """The entry's fingerprint: its one subset's, as ``check_corpus``
    cached it, else the whole dataset's."""
    if len(subsets) == 1 and subsets[0] in fps:
        return fps[subsets[0]]
    return corpus_fingerprint(ds)


def run_protocol(model, data_root: str, cfg_base, manifest: Optional[Dict] = None,
                 allow_corpus_mismatch: bool = False,
                 max_store_seconds: Optional[float] = None, fast: bool = False,
                 int8: bool = False, store_cache: Optional[Dict] = None) -> List[Dict]:
    """Every manifest accuracy entry → one record each.

    ``cfg_base``: an ExperimentConfig whose encoder and mode match ``model``;
    its fragment settings are replaced by the manifest's. Raises on a corpus
    that fails the identity check unless ``allow_corpus_mismatch`` (the
    records are then marked not comparable). ``int8``: embed through the
    int8 serving path, calibrated on each entry's store. ``store_cache``:
    the same dict passed to ``run_verification_protocol`` shares stores,
    calibrations and tables between the passes; it lives for one
    (cfg_base, corpus) pair (stores are keyed by subsets alone).
    """
    manifest = manifest or load_manifest()
    device = _model_device(model)
    results = []
    for entry in manifest["entries"]:
        cfg, ds, store, problems, fps = _entry_store(
            cfg_base, data_root, entry["subsets"], manifest, allow_corpus_mismatch,
            max_store_seconds, device, cache=store_cache)
        qvars = _entry_qvars(model, cfg, store, entry["subsets"], store_cache) if int8 else None
        table = _entry_table(model, cfg, store, entry["subsets"], fast, qvars, store_cache)
        acc = nshot.evaluate(model, store, cfg, jax_random.PRNGKey(int(manifest["task_seed"])),
                             num_tasks=entry["num_tasks"], n=entry["n_shot"], k=entry["k_way"],
                             fast=fast, qvars=qvars, table=table)
        stderr = math.sqrt(max(acc * (1 - acc), 1e-12) / entry["num_tasks"])
        z = float(manifest["acceptance"]["z"])
        results.append({
            "entry": entry["name"],
            "accuracy": round(float(acc), 4),
            "stderr": round(stderr, 4),
            "ci95": [round(float(acc) - z * stderr, 4), round(float(acc) + z * stderr, 4)],
            "num_tasks": entry["num_tasks"],
            "n_shot": entry["n_shot"],
            "k_way": entry["k_way"],
            "subsets": entry["subsets"],
            "task_seed": manifest["task_seed"],
            "corpus_fingerprint": _entry_fingerprint(ds, entry["subsets"], fps),
            "corpus_verified": not problems,
            "corpus_problems": problems,
            "comparable_to_reference": not problems,
            "int8": int8,
            "key_stream": jax_random.KEY_STREAM,
        })
    return results


def int8_accuracy_gate(model, data_root: str, cfg_base, manifest: Optional[Dict] = None,
                       allow_corpus_mismatch: bool = False,
                       max_store_seconds: Optional[float] = None, fast: bool = False,
                       store_cache: Optional[Dict] = None) -> Dict:
    """Does int8 serving keep the full-precision decisions under the frozen
    protocol? Every entry (accuracy, and EER and AUC) runs in full precision
    and through the int8 path calibrated on its store, on the same tasks and
    pairs; each metric pair is held to the manifest's z-test, ``agree iff
    |m_int8 − m_base| ≤ z·sqrt(se_base² + se_int8²)``.

    → ``{"int8_accuracy_gate": "pass" | "fail", "z", "checks": [one dict a
    metric of an entry], "comparable_to_reference"}``.
    """
    manifest = manifest or load_manifest()
    cache: Dict = {} if store_cache is None else store_cache
    kw = dict(manifest=manifest, allow_corpus_mismatch=allow_corpus_mismatch,
              max_store_seconds=max_store_seconds, fast=fast, store_cache=cache)
    base = (run_protocol(model, data_root, cfg_base, int8=False, **kw)
            + run_verification_protocol(model, data_root, cfg_base, int8=False, **kw))
    quant = (run_protocol(model, data_root, cfg_base, int8=True, **kw)
             + run_verification_protocol(model, data_root, cfg_base, int8=True, **kw))
    z = float(manifest["acceptance"]["z"])
    checks: List[Dict] = []
    for b, q in zip(base, quant):
        if b["entry"] != q["entry"]:
            raise RuntimeError("protocol pass order diverged")
        metrics = ([("accuracy", "stderr")] if "accuracy" in b
                   else [("eer", "eer_stderr"), ("auc", "auc_stderr")])
        for mkey, skey in metrics:
            diff = abs(float(q[mkey]) - float(b[mkey]))
            tol = z * math.sqrt(float(b[skey]) ** 2 + float(q[skey]) ** 2)
            checks.append({"entry": b["entry"], "metric": mkey, "base": float(b[mkey]),
                           "int8": float(q[mkey]), "diff": round(diff, 4),
                           "tolerance": round(tol, 4), "agree": diff <= tol})
    return {
        "int8_accuracy_gate": "pass" if all(c["agree"] for c in checks) else "fail",
        "z": z,
        "checks": checks,
        "comparable_to_reference": all(
            r.get("comparable_to_reference", r.get("comparable", False)) for r in base),
    }


def run_verification_protocol(model, data_root: str, cfg_base,
                              manifest: Optional[Dict] = None,
                              allow_corpus_mismatch: bool = False,
                              max_store_seconds: Optional[float] = None, fast: bool = False,
                              int8: bool = False,
                              store_cache: Optional[Dict] = None) -> List[Dict]:
    """The manifest's verification entries (protocol v2) → one record each:
    EER and AUC over ``num_pairs`` balanced pairs from ``PRNGKey(pair_seed)``,
    scored by ``eval/verification``'s rule, with their standard errors and
    intervals. The manifest's ``same_label`` sets only the labels of the
    reported pairs; the head's orientation stays the one it was trained
    with (``cfg.siamese.same_label``). A v1 manifest pins none: ``[]``."""
    manifest = manifest or load_manifest()
    ver = manifest.get("verification")
    if ver is None:
        return []
    device = _model_device(model)
    same_label = int(ver["same_label"])
    results = []
    for entry in ver["entries"]:
        cfg, ds, store, problems, fps = _entry_store(
            cfg_base, data_root, entry["subsets"], manifest, allow_corpus_mismatch,
            max_store_seconds, device, cache=store_cache)
        qvars = _entry_qvars(model, cfg, store, entry["subsets"], store_cache) if int8 else None
        table = _entry_table(model, cfg, store, entry["subsets"], fast, qvars, store_cache)
        scores, labels = V.verification_scores(
            model, store, cfg, jax_random.PRNGKey(int(ver["pair_seed"])),
            num_pairs=entry["num_pairs"], fast=fast, qvars=qvars, same_label=same_label,
            table=table)
        n_same = int((labels == same_label).sum())
        n_diff = int(len(labels) - n_same)
        eer, thr = V.eer_from_scores(scores, labels, same_label)
        auc = V.auc_from_scores(scores, labels, same_label)
        z = float(ver["acceptance"]["z"])
        se_eer = V.eer_stderr(eer, n_same, n_diff)
        se_auc = V.auc_stderr(auc, n_same, n_diff)
        results.append({
            "entry": entry["name"],
            "eer": round(eer, 4),
            "eer_threshold": round(thr, 4),
            "eer_stderr": round(se_eer, 4),
            "eer_ci95": [round(eer - z * se_eer, 4), round(eer + z * se_eer, 4)],
            "auc": round(auc, 4),
            "auc_stderr": round(se_auc, 4),
            "auc_ci95": [round(auc - z * se_auc, 4), round(auc + z * se_auc, 4)],
            "num_pairs": int(len(labels)),
            "n_same": n_same,
            "n_diff": n_diff,
            "pair_seed": int(ver["pair_seed"]),
            "same_label": same_label,
            "subsets": entry["subsets"],
            "corpus_verified": not problems,
            "corpus_problems": problems,
            "comparable": not problems,
            "int8": int8,
            "key_stream": jax_random.KEY_STREAM,
        })
    return results
