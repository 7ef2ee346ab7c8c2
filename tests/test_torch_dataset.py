"""The port's dataset (``lightningfastspeech2_tpu_torch/data``) against the
JAX package's, on the CPU, on one ``make_corpus`` corpus (2 speakers x 3
utterances, seed 0) shared by the module, with the flagship's variances:
frame-level pitch (CWT), energy and SNR, pitch and energy priors.

Entries, vocab, ``cache_key``, every integer and mask key, the speakers and
the d-vectors are equal. Float keys within these tolerances, each from
``test_torch_audio.py``'s reasons:
- mel: linear magnitudes within 2e-6 of the item's peak, log10 values
  within 1e-4 within 60 dB of it;
- pitch (CWT): the signal rtol 1e-5, the spectrogram atol 1e-6, mean and
  std rtol 1e-6 (the corpus puts no frame within ``YIN_MARGIN`` of a YIN
  decision that changes its F0; ``test_pitch_matches_jax_off_its_decisions``
  counts them);
- energy (z-normalized by the stats): de-normalized, within
  ``audio/features.py energy_rounding_bound`` (the f32 prefix sums);
- SNR: within ``audio/snr.py snr_rounding_bound`` over the item's range;
- the pitch prior rtol 1e-5; the energy prior, a mean of energies, within
  the largest frame's ``energy_error_bound``;
- the stats: each of min, max, mean and std moves at most by the largest
  frame's error, so energy and its prior within the square root of the
  largest utterance's energy bound, SNR within the largest SNR bound, the
  rest rtol 1e-5 with a floor of 1e-6.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.data import dataset as jds
from lightningfastspeech2_tpu.data import textgrid as jtg
from lightningfastspeech2_tpu.data.alignment import tier_to_alignment as j_tier_to_alignment
from lightningfastspeech2_tpu.data.synthetic import make_rich_corpus as j_make_rich_corpus
from lightningfastspeech2_tpu_torch.audio import features as tfeat
from lightningfastspeech2_tpu_torch.audio import snr as tsnr
from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
from lightningfastspeech2_tpu_torch.data import dataset as tds
from lightningfastspeech2_tpu_torch.data import textgrid as ttg
from lightningfastspeech2_tpu_torch.data.alignment import tier_to_alignment
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus, make_rich_corpus
from lightningfastspeech2_tpu_torch.audio.srmr import frame_srmr
from tests.torch_port_helpers import torch_threads

WIN = 1024
FLAGSHIP = dict(variances=("pitch", "energy", "snr"), variance_levels=("frame",) * 3,
                variance_transforms=("cwt", "none", "none"), priors=("pitch", "energy"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("ds_corpus"), n_speakers=2, n_utts=3, seed=0)


@pytest.fixture(scope="module")
def pair(corpus):
    """(port dataset on the CPU, JAX dataset), stats computed by each."""
    jd = jds.TTSDataset(corpus, jds.DataConfig(**FLAGSHIP))
    td = tds.TTSDataset(corpus, tds.DataConfig(**FLAGSHIP), device="cpu")
    return td, jd


def _close_mel(a, b):
    lin_a, lin_b = 10.0 ** a.astype(np.float64), 10.0 ** b.astype(np.float64)
    peak = lin_b.max()
    assert np.abs(lin_a - lin_b).max() <= 2e-6 * peak
    loud = lin_b >= 1e-3 * peak
    np.testing.assert_allclose(a[loud], b[loud], rtol=0, atol=1e-4)


def _close_item(a, b, wav, stats):
    """One item of each package, key for key (both normalized by
    ``stats``)."""
    assert set(a) == set(b)
    st = stats["energy"]
    ea, eb = (np.asarray(i["variances_energy"], np.float64) * st["std"] + st["mean"]
              for i in (a, b))
    e_bound = tfeat.energy_rounding_bound(wav, WIN)
    for k, y in b.items():
        x = a[k]
        if isinstance(y, str):
            assert x == y, k
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape)
        if y.dtype.kind in "biu" or k in ("speaker", "utterance_dvec"):
            np.testing.assert_array_equal(x, y, err_msg=k)
        elif k == "mel":
            _close_mel(x, y)
        elif k in ("variances_pitch_signal", "priors_pitch"):
            np.testing.assert_allclose(x, y, rtol=1e-5, err_msg=k)
        elif k == "priors_energy":
            assert abs(float(x) - float(y)) <= tfeat.energy_error_bound(ea, eb, e_bound).max()
        elif k == "variances_pitch_spectrogram":
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
        elif k in ("variances_pitch_mean", "variances_pitch_std"):
            np.testing.assert_allclose(x, y, rtol=1e-6)
        elif k == "variances_energy":
            assert np.abs(ea ** 2 - eb ** 2).max() <= e_bound
        elif k == "variances_snr":
            st = stats["snr"]
            sa, sb = x * st["std"] + st["mean"], y * st["std"] + st["mean"]
            assert np.abs(sa - sb).max() <= tsnr.snr_rounding_bound(wav, sb, WIN)
        else:
            raise AssertionError(f"unexpected key {k}")


def test_entries_vocab_and_cache_key_match_jax(pair, corpus):
    td, jd = pair
    assert len(td) == len(jd) == 6
    for e, f in zip(td.entries, jd.entries):
        assert (e.utt_id, e.audio_path, e.phones, e.start, e.end, e.speaker, e.text) == \
            (f.utt_id, f.audio_path, f.phones, f.start, f.end, f.speaker, f.text)
        np.testing.assert_array_equal(e.durations, f.durations)
        assert e.durations.dtype == f.durations.dtype
    assert td.vocab.to_dict() == jd.vocab.to_dict()
    assert td.speakers == jd.speakers and td.speaker2id == jd.speaker2id
    for s in jd.speaker2dvector:
        np.testing.assert_array_equal(td.speaker2dvector[s], jd.speaker2dvector[s])
    assert td.cache_key() == jd.cache_key()
    assert [f.name for f in dataclasses.fields(tds.DataConfig)] == \
        [f.name for f in dataclasses.fields(jds.DataConfig)]
    assert dataclasses.asdict(tds.DataConfig()) == dataclasses.asdict(jds.DataConfig())
    # scan_workers is a machine knob, not part of the key
    wide = tds.TTSDataset(corpus, tds.DataConfig(**FLAGSHIP, scan_workers=3),
                          compute_stats=False, device="cpu")
    assert wide.cache_key() == td.cache_key()


def test_stats_and_priors_match_jax(pair):
    td, jd = pair
    wavs = [td._load_audio(e) for e in td.entries]
    e_tol = np.sqrt(max(tfeat.energy_rounding_bound(w, WIN) for w in wavs))
    st = jd.stats["snr"]
    snr_tol = max(tsnr.snr_rounding_bound(w, jd[i]["variances_snr"] * st["std"] + st["mean"], WIN)
                  for i, w in enumerate(wavs))
    assert set(td.stats) == set(jd.stats)
    for key, ref in jd.stats.items():
        for s, v in ref.items():
            tol = {"energy": e_tol, "priors_energy": e_tol, "snr": snr_tol}.get(
                key, 1e-5 * abs(v) + 1e-6)
            assert abs(td.stats[key][s] - v) <= tol, (key, s, td.stats[key][s], v)
    tp, jp = td.create_priors(), jd.create_priors()
    assert set(tp) == set(jp)
    for spk in jp:
        for var in jp[spk]:
            tol = dict(rtol=1e-5) if var == "pitch" else dict(rtol=0, atol=e_tol)
            np.testing.assert_allclose(tp[spk][var], jp[spk][var], **tol)


@pytest.mark.parametrize("augment", [True, False], ids=["augmented", "plain"])
def test_full_items_match_jax(corpus, augment):
    """Every item, augmented (both draw from a Generator seeded cfg.seed, in
    the same order) and not, with stats given so that both normalize alike."""
    cfg = dict(FLAGSHIP, augment_duration=0.3)
    jd = jds.TTSDataset(corpus, jds.DataConfig(**cfg), compute_stats=False)
    jd.stats = jd._create_stats()
    td = tds.TTSDataset(corpus, tds.DataConfig(**cfg), stats=jd.stats, device="cpu")
    changed = 0
    for i in range(len(jd)):
        a, b = td.__getitem__(i, augment), jd.__getitem__(i, augment)
        changed += int((b["duration"] != td.entries[i].durations).any())
        _close_item(a, b, td._load_audio(td.entries[i]), jd.stats)
    assert (changed > 0) == augment


def test_raw_mode_items_match_jax(corpus):
    cfg = dict(FLAGSHIP, raw_mode=True, speaker_type="id")
    jd = jds.TTSDataset(corpus, jds.DataConfig(**cfg), compute_stats=False)
    td = tds.TTSDataset(corpus, tds.DataConfig(**cfg), compute_stats=False, device="cpu")
    for i in range(len(jd)):
        a, b = td[i], jd[i]
        assert set(a) == set(b) and "mel" not in a
        for k, y in b.items():
            if isinstance(y, str):
                assert a[k] == y
            else:
                assert np.asarray(a[k]).dtype == np.asarray(y).dtype, k
                np.testing.assert_array_equal(a[k], y, err_msg=k)
    ta, ja = td.collate([td[i] for i in range(4)]), jd.collate([jd[i] for i in range(4)])
    assert set(ta) == set(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # raw-mode stats run a full extraction, as in the JAX package
    st = tds.TTSDataset(corpus, tds.DataConfig(**cfg), device="cpu").stats
    assert set(st) == {"pitch", "energy", "snr", "mel", "duration", "priors_pitch",
                       "priors_energy"}


def test_collate_matches_jax(pair):
    td, jd = pair
    bucketer = Bucketer(512, 2816)
    items_t, items_j = [td[i] for i in range(len(td))], [jd[i] for i in range(len(jd))]
    ta, ja = td.collate(items_t), jd.collate(items_j)
    assert set(ta) == set(ja)
    assert ta["mel"].shape == ja["mel"].shape and ta["mel"].shape[1] % 256 == 0
    assert ta["phones"].shape[1] % 16 == 0
    for k in ja:
        x, y = ta[k], ja[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if y.dtype.kind in "biu" or k == "speaker":
            np.testing.assert_array_equal(x, y, err_msg=k)
    assert ta["phones"].dtype == np.int32 and ta["duration"].dtype == np.int32
    # padded frames: mel 0, silence mask 1, as the JAX collate pads them
    n = ta["mel_lengths"][0]
    assert (ta["mel"][0, n:] == 0).all() and ta["silence_mask"][0, n:].all()
    for i, (a, b) in enumerate(zip(items_t, items_j)):
        np.testing.assert_allclose(ta["variances_pitch_signal"][i, : len(a["mel"])],
                                   a["variances_pitch_signal"], rtol=0, atol=0)
        _close_mel(ta["mel"][i, : len(a["mel"])], ja["mel"][i, : len(b["mel"])])
    assert td.collate(items_t[:2], bucketer)["mel"].shape[1] == \
        jd.collate(items_j[:2], bucketer)["mel"].shape[1]


def test_bf16_mel_equals_ml_dtypes(pair):
    """Under mel_dtype="bfloat16" the mel is a CPU torch.bfloat16 tensor
    holding exactly the values the JAX package's ml_dtypes cast gives the
    same f32 batch (both round to nearest even)."""
    td, _ = pair
    items = [td[i] for i in range(len(td))]
    f32 = td.collate(items)
    cfg = dataclasses.replace(td.cfg, mel_dtype="bfloat16")
    bf = tds.collate(items, cfg)
    assert isinstance(bf["mel"], torch.Tensor) and bf["mel"].dtype == torch.bfloat16
    assert bf["mel"].device.type == "cpu"
    ref = jds._shrink_transfer({"mel": f32["mel"].copy()},
                               jds.DataConfig(mel_dtype="bfloat16"))["mel"]
    np.testing.assert_array_equal(bf["mel"].float().numpy(), ref.astype(np.float32))
    assert not np.array_equal(bf["mel"].float().numpy(), f32["mel"])
    wav = tds.collate([dict(i, wav=np.linspace(-1, 1, 100, dtype=np.float32)) for i in items[:2]],
                      dataclasses.replace(td.cfg, load_wav=True, wav_dtype="int16"))["wav"]
    assert wav.dtype == np.int16 and wav.max() == 32767 and wav.min() == -32768


def test_feature_cache_written_by_jax_serves_the_port(corpus, tmp_path, monkeypatch):
    """The JAX dataset's stats JSON and npz feature cache, read by the port:
    the stats load from the JSON (no extraction), and the items' features
    from the npz files (the port's extractor is not called)."""
    cfg = dict(FLAGSHIP, augment_duration=0.0)
    jd = jds.TTSDataset(corpus, jds.DataConfig(**cfg), cache_dir=tmp_path)
    assert len(list((tmp_path / "features").glob("*.npz"))) == len(jd)

    def no_extract(self, wav):
        raise AssertionError("features must come from the JAX package's cache")

    monkeypatch.setattr(tds.TTSDataset, "_extract", no_extract)
    td = tds.TTSDataset(corpus, tds.DataConfig(**cfg), cache_dir=tmp_path, device="cpu")
    assert td.stats == jd.stats and td.vocab.to_dict() == jd.vocab.to_dict()
    for i in range(len(td)):
        a, b = td[i], jd[i]
        for k in ("mel", "variances_energy", "variances_snr", "variances_pitch_signal"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_scan_and_stats_workers_equal_serial(tmp_path):
    """``scan_workers=2``: the spawn-pool scan and stats give the serial
    run's entries and stats (each worker extracts on the dataset's device)."""
    root = make_corpus(tmp_path / "c", n_speakers=2, n_utts=6, seed=1)
    serial = tds.TTSDataset(root, tds.DataConfig(**FLAGSHIP), device="cpu")
    pooled = tds.TTSDataset(root, tds.DataConfig(**FLAGSHIP, scan_workers=2), device="cpu")
    assert len(serial) >= 8
    assert [e.utt_id for e in pooled.entries] == [e.utt_id for e in serial.entries]
    assert pooled.stats.keys() == serial.stats.keys()
    for key, st in serial.stats.items():
        for s, v in st.items():
            assert pooled.stats[key][s] == pytest.approx(v, rel=1e-12, abs=1e-12), (key, s)


def test_validation_split_and_sharding(pair, corpus):
    td, jd = pair
    tv = td.create_validation_dataset(corpus)
    jv = jd.create_validation_dataset(corpus)
    assert tv.device == "cpu" and tv.stats is td.stats and tv.vocab is td.vocab
    assert [e.utt_id for e in tv.entries] == [e.utt_id for e in jv.entries]
    assert td.shard_across_hosts() is td and len(td) == 6
    td2 = pickle.loads(pickle.dumps(td))
    assert td2.device == "cpu" and len(td2) == len(td)


def test_unported_parts_name_a16(corpus):
    """Both halves of A16 are ported. The d-vectors (data/dvector.py, held
    against the JAX package in test_torch_dvector.py): without the cache
    nothing is written beside the audio, so the shared corpus keeps no
    d-vector files. The ``srmr`` variance (audio/srmr.py, held against the
    JAX package in test_torch_srmr.py): each item's is ``frame_srmr`` of its
    wav on the mel grid, z-normalized by the dataset's stats."""
    fresh = tds.TTSDataset(corpus, tds.DataConfig(**FLAGSHIP), device="cpu",
                           compute_stats=False)
    table = fresh.create_dvectors(cache=False)
    assert set(table) == set(fresh.speakers)
    for spk, vec in table.items():
        assert vec.shape == (256,) and abs(float(np.linalg.norm(vec)) - 1) < 0.5
        assert not np.array_equal(vec, tds._hash_dvector(spk))
    assert fresh.dvector_suffix == ".npy" and dict(fresh.get_speaker_dvectors()) == {}
    ds = tds.TTSDataset(corpus, tds.DataConfig(variances=("pitch", "srmr"),
                                               variance_levels=("frame", "frame"),
                                               variance_transforms=("none", "none"),
                                               augment_duration=0.0, load_wav=True),
                        device="cpu")
    st = ds.stats["srmr"]
    assert st["std"] > 0 and st["min"] < st["mean"] < st["max"]
    item = ds[0]
    want = frame_srmr(item["wav"], len(item["mel"]), device="cpu")
    np.testing.assert_allclose(item["variances_srmr"],
                               ((want - st["mean"]) / st["std"]).astype(np.float32), rtol=1e-6)


def test_default_device_raises_without_cuda(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.TTSDataset(corpus, tds.DataConfig(**FLAGSHIP), compute_stats=False)


def test_textgrid_alignment_and_rich_corpus_copies(tmp_path):
    """The numpy-only copies: a rich corpus written by each package is the
    same bytes, and parses and aligns the same."""
    a = make_rich_corpus(tmp_path / "t", n_speakers=1, n_utts=2, seed=5)
    b = j_make_rich_corpus(tmp_path / "j", n_speakers=1, n_utts=2, seed=5)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()) and files
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
        if f.suffix == ".TextGrid":
            tg, jg = ttg.load(a / f), jtg.load(a / f)
            assert ttg.dump(tg) == jtg.dump(jg) == (a / f).read_text()
            assert tier_to_alignment(tg.tier("phones"), 22050, 256) == \
                j_tier_to_alignment(jg.tier("phones"), 22050, 256)
