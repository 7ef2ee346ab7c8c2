"""The port's batch order and prefetch loader (``data/loader.py``) against
the JAX package's ``batch_index_stream``, and the loader's batches against
the synchronous order, on the CPU: one ``PrefetchLoader`` run with 2 spawn
workers on ``device="cpu"`` must yield, batch for batch, what
``dataset.collate`` gives the same index lists read in order (equal arrays:
the workers run the same code on the same device)."""

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.data.loader import batch_index_stream as j_stream
from lightningfastspeech2_tpu_torch.data import dataset as tds
from lightningfastspeech2_tpu_torch.data.loader import PrefetchLoader, batch_index_stream
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus


@pytest.mark.parametrize("sort", [False, True], ids=["shuffled", "length_sorted"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batch_index_stream_matches_jax(sort, seed):
    g = np.random.default_rng(seed)
    n, bs = 37, 4
    lengths = g.integers(10, 500, n) if sort else None
    ours = batch_index_stream(n, bs, shuffle=True, seed=seed, epochs=3, lengths=lengths)
    ref = j_stream(n, bs, shuffle=True, seed=seed, epochs=3, lengths=lengths)
    a, b = list(ours), list(ref)
    assert a == b and len(a) == 3 * (n // bs)
    assert list(batch_index_stream(n, bs, shuffle=False, epochs=1)) == \
        list(j_stream(n, bs, shuffle=False, epochs=1))
    with pytest.raises(ValueError, match="batch_size"):
        next(batch_index_stream(3, 4))


def test_prefetch_loader_equals_synchronous_order(tmp_path):
    root = make_corpus(tmp_path / "c", n_speakers=2, n_utts=3, seed=0)
    cfg = tds.DataConfig(variances=("pitch", "energy", "snr"), variance_levels=("frame",) * 3,
                         variance_transforms=("cwt", "none", "none"), augment_duration=0.0)
    ds = tds.TTSDataset(root, cfg, device="cpu")
    loader = PrefetchLoader(ds, batch_size=2, seed=3, epochs=2, sort_by_length=True,
                            num_workers=2, prefetch=2, device="cpu")
    order = list(loader.index_stream())
    assert len(order) == 6
    with loader:
        got = list(loader)
    assert loader._pool is None
    assert len(got) == len(order)
    for batch, idx in zip(got, order):
        ref = ds.collate([ds[i] for i in idx], loader.bucketer)
        assert set(batch) == set(ref)
        for k in ref:
            assert batch[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(batch[k], ref[k], err_msg=k)


def test_loader_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(object(), batch_size=2, bucketer=tds.Bucketer())
