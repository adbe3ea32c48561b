"""The port's pandas-free data layer against the JAX package's, on the CPU.

Every comparison is exact: the same seed must write the same bytes, read the
same samples, index the same rows and draw the same fragments, batches,
pairs and tasks (host draws are numpy on both sides, called in the same
order). The corpora are written by the JAX package's ``generate_corpus``
(the port's must write the same bytes), with short utterances so that the
pure-Python FLAC encoder stays quick.
"""

import filecmp
import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from voicemap_tpu.data import audio as jaudio
from voicemap_tpu.data import dataset as jdataset
from voicemap_tpu.data import flac_enc as jflac_enc
from voicemap_tpu.data import flac_ext as jflac_ext
from voicemap_tpu.data import index as jindex
from voicemap_tpu.data import preprocessing as jpre
from voicemap_tpu.data import synthetic as jsynthetic
from voicemap_tpu_torch.data import audio, dataset, flac_enc, flac_ext, index
from voicemap_tpu_torch.data import preprocessing as tpre
from voicemap_tpu_torch.data import synthetic
from voicemap_tpu_torch.data.store import AudioStore

SUBSETS = ("dev-clean", "test-clean")
COLUMNS = ["filepath", "speaker_id", "sex", "samples", "sample_rate", "seconds"]


def spec(container):
    # 0.4-1.2 s utterances: a 0.5 s fragment drops some files, pad keeps them
    return synthetic.SyntheticSpec(n_speakers=5, utterances_per_speaker=4, min_seconds=0.4,
                                   max_seconds=1.2, seed=17, container=container)


def jax_spec(container):
    return jsynthetic.SyntheticSpec(**vars(spec(container)))


@pytest.fixture(scope="module", params=["wav", "flac"])
def corpus(request, tmp_path_factory):
    """(container, the JAX package's corpus root, the port's corpus root)."""
    jroot = tmp_path_factory.mktemp(f"jax_{request.param}")
    troot = tmp_path_factory.mktemp(f"port_{request.param}")
    jpaths = jsynthetic.generate_corpus(str(jroot), SUBSETS, jax_spec(request.param))
    tpaths = synthetic.generate_corpus(str(troot), SUBSETS, spec(request.param))
    return request.param, str(jroot), str(troot), jpaths, tpaths


@pytest.fixture(scope="module")
def flac_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("flac_corpus")
    jsynthetic.generate_corpus(str(root), SUBSETS, jax_spec("flac"))
    return str(root)


def test_generate_corpus_writes_the_same_bytes(corpus):
    container, jroot, troot, jpaths, tpaths = corpus
    rel = lambda paths, root: [os.path.relpath(p, root) for p in paths]  # noqa: E731
    assert rel(tpaths, troot) == rel(jpaths, jroot) and len(tpaths) == 40
    assert all(p.endswith("." + container) for p in tpaths)
    for a, b in zip(jpaths, tpaths):
        assert filecmp.cmp(a, b, shallow=False), b
    assert filecmp.cmp(os.path.join(jroot, "LibriSpeech", "SPEAKERS.TXT"),
                       os.path.join(troot, "LibriSpeech", "SPEAKERS.TXT"), shallow=False)


def signal(n=20000, seed=0, stereo=False):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)
    x = (x * 12000).astype(np.int16)
    return np.stack([x, (x // 3).astype(np.int16)], axis=1) if stereo else x


@pytest.mark.parametrize("kw", [
    dict(mode="fixed"), dict(mode="verbatim"), dict(mode="constant"), dict(mode="lpc"),
    dict(mode="fixed", rice2=True, partition_order=3), dict(mode="fixed", force_escape=True),
    dict(mode="fixed", wasted_bits=2), dict(mode="fixed", block_size=1152),
    dict(mode="fixed", stereo_mode="left_side", stereo=True),
    dict(mode="fixed", stereo=True)], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_flac_encoder_writes_the_jax_encoders_bytes(kw):
    kw = dict(kw)
    x = signal(9000, seed=3, stereo=kw.pop("stereo", False))
    if kw.get("wasted_bits"):
        x = (x >> kw["wasted_bits"] << kw["wasted_bits"]).astype(np.int16)
    if kw["mode"] == "constant":
        x = np.full(5000, -123, np.int16)
    assert flac_enc.encode(x, 16000, **kw) == jflac_enc.encode(x, 16000, **kw)


def test_the_decoder_is_built_in_the_build_directory():
    path = flac_ext.build()
    assert path == flac_ext.library_path() and path.exists()
    assert path.parent == flac_ext.BUILD_DIR and path.parent.parts[-2:] == ("build", "flac")
    assert flac_ext.SOURCE.read_bytes().split(b"namespace {")[1] == open(
        jflac_ext._SRC, "rb").read().split(b"namespace {")[1]  # the same decoder
    lib = flac_ext._load()
    assert lib._name == str(path) and not lib._name.startswith(os.path.dirname(jflac_ext._SRC))


def test_the_decoder_reads_what_the_jax_decoder_reads(flac_root, tmp_path):
    """Every corpus file, single and batch (threaded), and a stereo file
    (mean-downmixed), probe included."""
    paths = sorted(str(p) for p in Path(flac_root).rglob("*.flac"))
    stereo = str(tmp_path / "stereo.flac")
    jflac_ext.write(stereo, signal(7000, seed=4, stereo=True), 16000,
                    stereo_mode="left_side")
    paths.append(stereo)
    batch = flac_ext.read_batch(paths, n_threads=3)
    jbatch = jflac_ext.read_batch(paths, n_threads=3)
    for p, got_b, want_b in zip(paths, batch, jbatch):
        got, sr = flac_ext.read(p)
        want, jsr = jflac_ext.read(p)
        assert sr == jsr == 16000 and got.dtype == np.int16
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_b, want_b)
        np.testing.assert_array_equal(got_b, got)
        assert flac_ext.probe(p) == jflac_ext.probe(p) == audio.probe(p)


def test_wav_and_float_conversion_match(corpus, tmp_path):
    container, jroot, troot, jpaths, _ = corpus
    for p in jpaths[:6]:
        got, sr = audio.read(p)
        want, jsr = jaudio.read(p)
        np.testing.assert_array_equal(got, want)
        assert sr == jsr and audio.probe(p) == jaudio.probe(p)
        np.testing.assert_array_equal(audio.to_float(got), jaudio.to_float(want))
    x = signal(3000, seed=5)
    audio.write_wav(str(tmp_path / "a.wav"), x, 8000)
    jaudio.write_wav(str(tmp_path / "b.wav"), x, 8000)
    assert filecmp.cmp(tmp_path / "a.wav", tmp_path / "b.wav", shallow=False)
    with pytest.raises(ValueError):
        audio.read(str(tmp_path / "x.mp3"))


def assert_index_equals_frame(idx: index.Index, df: pd.DataFrame):
    assert len(idx) == len(df)
    for col in COLUMNS + ["subset", "id"]:
        got = getattr(idx, col)
        want = df[col].to_numpy()
        assert got.tolist() == want.tolist(), col
        if col in ("speaker_id", "samples", "sample_rate", "id"):
            assert got.dtype == np.int64
        if col == "seconds":
            assert got.dtype == np.float64


def test_index_rows_equal_the_jax_frame(corpus):
    _, jroot, _, _, _ = corpus
    for subset in SUBSETS:
        idx = index.index_subset(jroot, subset)
        df = jindex.index_subset(jroot, subset).assign(subset=subset)
        df["id"] = np.arange(len(df))
        assert_index_equals_frame(idx, df)
    both = index.load_index(jroot, SUBSETS, use_cache=False)
    assert_index_equals_frame(both, jindex.load_index(jroot, SUBSETS, use_cache=False))
    assert index.read_speakers_txt(os.path.join(jroot, "LibriSpeech", "SPEAKERS.TXT")) == (
        jindex.read_speakers_txt(os.path.join(jroot, "LibriSpeech", "SPEAKERS.TXT"))
        .to_dict("records"))
    assert index.subset_available(jroot, "dev-clean")
    assert not index.subset_available(jroot, "train-other-500")


def test_the_index_cache_reads_across_both_ways(corpus, tmp_path):
    """A cache written by pandas reads in the port to the same rows and types,
    and a cache written by the port reads in pandas to an equal frame (and is
    the same file), with a '?' sex among the rows."""
    _, jroot, _, _, _ = corpus
    root = tmp_path / "r"
    shutil.copytree(jroot, root)
    speakers = root / "LibriSpeech" / "SPEAKERS.TXT"
    lines = speakers.read_text().splitlines()
    speakers.write_text("\n".join(lines[:4]) + "\n")  # one speaker listed, the rest '?'
    jdf = jindex.load_index(str(root), ("dev-clean",), use_cache=True)  # pandas writes
    written_by_pandas = (root / "dev-clean.index.csv").read_bytes()
    got = index.load_index(str(root), ("dev-clean",), use_cache=True)
    assert_index_equals_frame(got, jdf)
    assert "?" in set(got.sex) and len(set(got.sex)) == 2
    os.remove(root / "dev-clean.index.csv")
    index.load_index(str(root), ("dev-clean",), use_cache=True)  # the port writes
    assert (root / "dev-clean.index.csv").read_bytes() == written_by_pandas
    frame = pd.read_csv(root / "dev-clean.index.csv")
    pd.testing.assert_frame_equal(frame, jindex.index_subset(str(root), "dev-clean"))


def dataset_pair(root, seconds=0.5, seed=3, **kw):
    t = dataset.SpeakerDataset(SUBSETS, seconds, data_root=root, seed=seed, use_cache=False,
                               **kw)
    j = jdataset.SpeakerDataset(SUBSETS, seconds, data_root=root, seed=seed,
                                use_cache=False, **kw)
    return t, j


@pytest.mark.parametrize("kw", [dict(), dict(pad=True), dict(label="sex"),
                                dict(stochastic=False)], ids=["default", "pad", "sex",
                                                              "deterministic"])
def test_the_dataset_draws_what_the_jax_dataset_draws(corpus, kw):
    """The same seed: the same fragments, classifier batches, alike and
    differing pairs, verification batches and n-shot tasks, in turn."""
    _, jroot, _, _, _ = corpus
    t, j = dataset_pair(jroot, **kw)
    assert len(t) == len(j) and t.num_classes() == j.num_classes()
    assert t.unique_speakers == j.unique_speakers
    assert t.speaker_id_mapping == j.speaker_id_mapping
    for i in (0, 3, len(t) - 1):
        (xt, lt), (xj, lj) = t[i], j[i]
        np.testing.assert_array_equal(xt, xj)
        assert lt == lj
    for _ in range(2):
        xt, yt = t.build_classifier_batch(6)
        xj, yj = j.build_classifier_batch(6)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
        assert t.get_alike_pairs(5) == j.get_alike_pairs(5)
        assert t.get_differing_pairs(5) == j.get_differing_pairs(5)
        (at, bt), vt = t.build_verification_batch(7, same_label=1)
        (aj, bj), vj = j.build_verification_batch(7, same_label=1)
        for a, b in ((at, aj), (bt, bj), (vt, vj)):
            np.testing.assert_array_equal(a, b)
        for n in (1, 2):
            (qt, qlt), (st, slt) = t.build_n_shot_task(3, n)
            (qj, qlj), (sj, slj) = j.build_n_shot_task(3, n)
            np.testing.assert_array_equal(qt, qj)
            np.testing.assert_array_equal(st, sj)
            np.testing.assert_array_equal(slt, slj)
            assert qlt == qlj
    assert t.rng.integers(1 << 30) == j.rng.integers(1 << 30)  # the streams stay in step


def test_pad_sex_and_the_short_file_filter(corpus):
    """Short files are dropped before the ids are renumbered (and kept with
    pad); a sex-labelled dataset has two classes; a fragment longer than
    every file fails as the JAX class does."""
    _, jroot, _, _, _ = corpus
    t, j = dataset_pair(jroot)
    t_pad, _ = dataset_pair(jroot, pad=True)
    assert len(t) < len(t_pad) == 40
    assert (t.index.samples >= t.fragment_length).all()
    assert t.index.id.tolist() == list(range(len(t)))
    assert t.datasetid_to_filepath == dict(zip(j.df.id, j.df.filepath))
    sex, jsex = dataset_pair(jroot, label="sex")
    assert sex.num_classes() == jsex.num_classes() == 2
    with pytest.raises(ValueError):
        dataset.SpeakerDataset(SUBSETS, 5.0, data_root=jroot, use_cache=False)
    with pytest.raises(ValueError):
        dataset.SpeakerDataset(SUBSETS, 0.5, data_root=jroot, label="age")


@pytest.mark.parametrize("label", ["speaker", "sex"])
@pytest.mark.parametrize("max_seconds", [None, 0.6])
def test_to_store_and_its_size_equal_the_jax_packages(corpus, label, max_seconds):
    _, jroot, _, _, _ = corpus
    t, j = dataset_pair(jroot, label=label, pad=True)
    got, want = t.to_store(max_seconds), j.to_store(max_seconds)
    assert isinstance(got, AudioStore)
    for name in ("audio", "lengths", "labels", "speaker_utts", "speaker_counts"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.sample_rate == want.sample_rate
    assert [int(x) if label == "speaker" else x for x in got.label_names] == [
        int(x) if label == "speaker" else x for x in want.label_names]
    assert dataset.estimate_store_bytes(t, max_seconds, 16000) == (
        jdataset.estimate_store_bytes(j, max_seconds, 16000))


def test_dataset_from_config_and_the_streaming_threshold(corpus):
    from test_torch_config import jax_config
    from voicemap_tpu_torch.config import DataConfig

    _, jroot, _, _, _ = corpus
    cfg = DataConfig(data_root=jroot, subsets=SUBSETS, seconds=0.5, use_cache=False)
    t = dataset.dataset_from_config(cfg, seed=4)
    j = jdataset.dataset_from_config(jax_config(cfg), seed=4)
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.build_classifier_batch(4)[0], j.build_classifier_batch(4)[0])
    host = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    assert dataset.streaming_threshold_bytes("cpu") == int(dataset.STREAMING_THRESHOLD_SHARE
                                                           * host)
    assert 0 < dataset.STREAMING_THRESHOLD_SHARE < 1


def test_host_preprocessing_matches():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 400, 1)) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(tpre.whiten(x), jpre.whiten(x))
    np.testing.assert_array_equal(tpre.preprocess_instances(4)(x),
                                  jpre.preprocess_instances(4)(x))
    mapping = {19: 0, 23: 1, 30: 2}
    labels = np.asarray([23, 19, 30, 23])
    np.testing.assert_array_equal(tpre.label_preprocessor(3, mapping)(labels),
                                  jpre.label_preprocessor(3, mapping)(labels))
    for mode, batch in (("classifier", (x, labels)), ("siamese", ([x, x[::-1]], labels))):
        got = tpre.BatchPreProcessor(mode, tpre.preprocess_instances(2),
                                     tpre.label_preprocessor(3, mapping))(batch)
        want = jpre.BatchPreProcessor(mode, jpre.preprocess_instances(2),
                                      jpre.label_preprocessor(3, mapping))(batch)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        tpre.whiten(x[0, :, 0])
    with pytest.raises(ValueError):
        tpre.BatchPreProcessor("pairs", tpre.preprocess_instances(2))
