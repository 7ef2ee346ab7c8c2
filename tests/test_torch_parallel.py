"""Data-parallel training (parallel/mesh.py, train/losses.py, train/step.py,
train/loop.py, core/checkpoint.py, cli/train.py) in a world of two gloo
processes on the CPU, against the JAX package's global-batch step in one
process and against the port's own one-process step.

One pair of workers (tests/torch_parallel_worker.py, no JAX) runs every
case of the file and writes its results; meanwhile this process computes
the references. The global batch of 4 gives rank 0 two long items (8 and 6
phones) and rank 1 two short ones (3 and 2), so that a per-rank mean is not
the global one; the config has a frame-level CWT pitch (per-item mean and
std terms) and a phone-level energy. Each step case runs plain, with ZeRO-1,
with ZeRO-1 and bf16 moments, with two micro-batches, and with the soft-DTW
mel loss (a sum over items)."""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.data import dataset as tds
from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_port_helpers import seeded_params, tiny_config, torch_threads

ROOT = Path(__file__).resolve().parent.parent
CASES = ("plain", "zero1", "zero1_bf16", "accum2", "soft_dtw")
# test_torch_train_step.py's tolerances against the JAX package
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-7
UPDATE_ATOL = 2e-6
# two ranks against one process: the same f32 arithmetic in another order
ROUND_RTOL, ROUND_ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _cfg(C, case="plain"):
    """``tiny_config`` with a frame-level CWT pitch and a phone-level
    energy, every dropout rate 0, warm-up 1, and the case's training
    options."""
    var = C.VarianceConfig(variances=("pitch", "energy"), levels=("frame", "phone"),
                           transforms=("cwt", "none"), losses=("mse", "mse"), nlayers=(2, 2),
                           kernel_sizes=(3, 3), dropouts=(0.0, 0.0),
                           loss_weights=(5e-2, 5e-2), filter_size=32, nbins=16)
    cfg = tiny_config(C, variance=var)
    m = cfg.model
    train = {"train.warmup_steps": 1, "train.batch_size": 4,
             "train.zero1": case.startswith("zero1"),
             "train.bf16_moments": case == "zero1_bf16"}
    if case == "soft_dtw":
        train.update({"train.mel_loss": "soft_dtw", "train.soft_dtw_chunk_size": 48})
    return C.replace(cfg, **{
        "model.encoder": C.replace(m.encoder, dropout=0.0),
        "model.decoder": C.replace(m.decoder, dropout=0.0),
        "model.duration": C.replace(m.duration, dropout=0.0), **train})


def _global_batch(C):
    """4 items of 8, 6, 3 and 2 valid phones (31 frames a phone)."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import make_dummy_batch

    batch = make_dummy_batch(_cfg(C).model, batch_size=4, n_phones=8, seed=0)
    for i, n in ((1, 6), (2, 3), (3, 2)):
        batch["phones"][i, n:] = 0
        batch["duration"][i, n:] = 0
    return batch


def _accum(batch):
    out = {k: np.stack([v] * 2) for k, v in batch.items()}
    out["mel"][1] = out["mel"][1][:, ::-1] * 0.5   # the second micro-batch differs
    return out


def _case_batch(batch, case):
    return _accum(batch) if case == "accum2" else batch


CLI_TINY = ("--variances pitch energy --variance_levels frame phone --variance_transforms "
            "cwt none --variance_nlayers 2 2 --encoder_hidden 32 --decoder_hidden 32 "
            "--encoder_layers 2 --decoder_layers 2 --encoder_kernel_sizes 3 5 "
            "--decoder_kernel_sizes 5 3 --encoder_conv_filter_size 64 "
            "--decoder_conv_filter_size 64 --variance_filter_size 32 --duration_filter_size 32 "
            "--stat_entries 4 --augment_duration 0 --precision 32 --encoder_dropout 0 "
            "--decoder_dropout 0 --variance_dropout 0 0 --duration_dropout 0 "
            "--warmup_steps 1").split()


def _jax_references(work: Path, batch):
    """The JAX package's step on the global batch in one process, for each
    case: metrics, parameters before and after, and the clipped gradient
    (from the first Adam moment; the plain case's for the bf16 moments)."""
    import jax
    import jax.numpy as jnp

    from lightningfastspeech2_tpu.core import config as JC
    from lightningfastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
    from lightningfastspeech2_tpu.train.optim import make_optimizer
    from lightningfastspeech2_tpu.train.step import TrainState, make_train_step

    jcfg = _cfg(JC)
    assert JC.to_dict(jcfg) == TC.to_dict(_cfg(TC))
    model = JaxFastSpeech2(jcfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "sdp": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda b: model.init(rngs, b, deterministic=True), jb)
    params0 = seeded_params(shapes["params"], 0)
    from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastspeech2

    port0 = from_jax_fastspeech2(params0, _cfg(TC).model)
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in port0.items()}, work / "params.pt")
    refs = {}
    for case in CASES:
        cfg = _cfg(JC, case)
        optimizer = make_optimizer(cfg.train)
        params = jax.tree_util.tree_map(jnp.asarray, params0)
        state = TrainState(params, optimizer.init(params), jnp.zeros((), jnp.int32))
        step = make_train_step(model, cfg, optimizer, donate=False)
        b = {k: jnp.asarray(v) for k, v in _case_batch(batch, case).items()}
        new, metrics = step(state, b, jax.random.PRNGKey(1))
        mu = _adam_mu(new.opt_state)
        refs[case] = SimpleNamespace(
            metrics={k: float(v) for k, v in metrics.items()},
            after=from_jax_fastspeech2(jax.tree_util.tree_map(np.asarray, new.params),
                                       cfg.model),
            grad=None if case == "zero1_bf16" else {
                k: v / 0.1 for k, v in from_jax_fastspeech2(mu, cfg.model).items()})
    refs["zero1_bf16"].grad = refs["plain"].grad
    return port0, refs


def _adam_mu(opt_state):
    import jax

    if hasattr(opt_state, "mu"):
        return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), opt_state.mu)
    for s in opt_state if isinstance(opt_state, tuple) else ():
        mu = _adam_mu(s)
        if mu is not None:
            return mu
    return None


def _one_process(port0, batch, case):
    """The port's step on the whole global batch in this process."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg = _cfg(TC, case)
    model = build_fastspeech2(cfg.model, device="cpu", state_dict=port0)
    state = create_train_state(model, cfg)
    state, metrics = make_train_step(model, cfg)(state, _case_batch(batch, case),
                                                 torch.Generator().manual_seed(0))
    return SimpleNamespace(metrics={k: float(v) for k, v in metrics.items()},
                           after={n: v.numpy().copy() for n, v in model.state_dict().items()},
                           grad={n: p.grad.numpy().copy() for n, p in model.named_parameters()})


def _rank_step(path: Path):
    z = np.load(path)
    return SimpleNamespace(
        metrics={k[8:]: float(z[k]) for k in z.files if k.startswith("metric::")},
        after={k[7:]: z[k] for k in z.files if k.startswith("param::")},
        grad={k[6:]: z[k] for k in z.files if k.startswith("grad::")},
        zero1=bool(z["zero1"]), z=z)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus

    work = tmp_path_factory.mktemp("parallel")
    batch = _global_batch(TC)
    np.savez(work / "batch.npz", **batch)
    np.savez(work / "batch_accum2.npz", **_accum(batch))
    for case in CASES:
        TC.save_json(_cfg(TC, case), str(work / f"cfg_{case}.json"))
    (work / "cases.json").write_text(json.dumps(CASES))
    corpus = make_corpus(work / "cli" / "corpus", n_speakers=2, n_utts=4, seed=42)
    run = work / "cli"
    argv = ["--train_target_path", str(corpus), "--valid_target_path", str(corpus),
            "--checkpoint_dir", str(run / "ckpt"), "--log_dir", str(run / "logs"),
            "--cache_path", str(run / "cache"), "--max_steps", "2", "--batch_size", "2",
            "--eval_every", "2", "--checkpoint_every", "1", "--log_every", "1",
            "--num_workers", "0", "--zero1", "True", "--device", "cpu"] + CLI_TINY
    (work / "cli_argv.json").write_text(json.dumps(argv))
    port0, refs = _jax_references(work, batch)

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", str(r), "2",
                               str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        one = {case: _one_process(port0, batch, case) for case in CASES}
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-6000:]}"
    ranks = [{case: _rank_step(work / f"rank{r}_step_{case}.npz") for case in CASES}
             for r in range(2)]
    return SimpleNamespace(work=work, batch=batch, port0=port0, refs=refs, one=one,
                           ranks=ranks, argv=argv, run=run,
                           cli=[json.loads((work / f"rank{r}_cli.json").read_text())
                                for r in range(2)],
                           axis=[_rank_step(work / f"rank{r}_model_axis.npz") for r in range(2)])


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_jax_global_batch(world, case):
    """Rank 0's metrics, clipped gradient and update against the JAX
    package's step on the global batch, at test_torch_train_step.py's
    tolerances."""
    got, ref = world.ranks[0][case], world.refs[case]
    assert got.zero1 == case.startswith("zero1")
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    n_moved = 0
    for name, after_ref in ref.after.items():
        g_ref = ref.grad[name]
        np.testing.assert_allclose(got.grad.get(name, np.zeros_like(g_ref)), g_ref,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
        upd_ref = after_ref - world.port0[name]
        upd = got.after[name] - world.port0[name]
        sure = np.abs(g_ref) > 1e-6
        np.testing.assert_allclose(upd[sure], upd_ref[sure], rtol=0, atol=UPDATE_ATOL,
                                   err_msg=name)
        n_moved += int(np.abs(upd_ref).max() > 5e-5)
    assert n_moved > 0.8 * len(ref.after)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_one_process(world, case):
    """Both ranks against the port's one-process step on the global batch:
    f32 rounding apart, and the two ranks hold one model."""
    one = world.one[case]
    r0, r1 = (world.ranks[r][case] for r in range(2))
    for k, v in one.metrics.items():
        np.testing.assert_allclose(r0.metrics[k], v, rtol=ROUND_RTOL, atol=ROUND_ATOL, err_msg=k)
        assert r1.metrics[k] == r0.metrics[k], k
    for name, grad in one.grad.items():
        np.testing.assert_allclose(r0.grad[name], grad, rtol=ROUND_RTOL, atol=ROUND_ATOL,
                                   err_msg=name)
    for name, after in one.after.items():
        np.testing.assert_allclose(r0.after[name], after, rtol=ROUND_RTOL, atol=ROUND_ATOL,
                                   err_msg=name)
        np.testing.assert_array_equal(r1.after[name], r0.after[name], err_msg=name)


def _rows(tree, rows):
    """Every batch-major tensor of a (nested) model output or batch, sliced."""
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return tree[rows] if torch.is_tensor(tree) and tree.dim() and tree.shape[0] == 4 else tree


def test_per_rank_means_would_miss(world):
    """The batch exercises the trap: on the global batch's forward, the mean
    of the two ranks' own masked-mean losses is not the global loss, by far
    more than the tolerance the two-rank step meets."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.losses import compute_losses

    cfg = _cfg(TC)
    model = build_fastspeech2(cfg.model, device="cpu", state_dict=world.port0)
    b = {k: torch.from_numpy(v) for k, v in world.batch.items()}
    model.train()
    with torch.no_grad():
        out = model(b, tf=True, generator=torch.Generator().manual_seed(0))
        whole = compute_losses(out, b, cfg)
        halves = [compute_losses(_rows(out, rows), _rows(b, rows), cfg)
                  for rows in (slice(0, 2), slice(2, 4))]
    lens = world.batch["phones"].astype(bool).sum(1)
    assert lens[:2].sum() > 2 * lens[2:].sum()
    for key in ("mel", "energy", "pitch_cwt", "duration", "total"):
        averaged = (float(halves[0][key]) + float(halves[1][key])) / 2
        rel = abs(averaged - float(whole[key])) / abs(float(whole[key]))
        assert rel > 100 * LOSS_RTOL, (key, rel)
        np.testing.assert_allclose(world.ranks[0]["plain"].metrics[key], float(whole[key]),
                                   rtol=ROUND_RTOL, err_msg=key)


def test_model_axis_replicates(world):
    """A (data 1, model 2) mesh: each rank steps the whole batch and gets
    the one-process step exactly; no rank shards the optimizer."""
    one = world.one["plain"]
    for r, got in enumerate(world.axis):
        assert int(got.z["model_rank"]) == r and int(got.z["data_rank"]) == 0
        assert not got.zero1
        assert got.metrics == one.metrics
        for name, after in one.after.items():
            np.testing.assert_array_equal(got.after[name], after, err_msg=name)


def test_cli_zero1_only_rank0_writes(world):
    """The 2-rank ZeRO-1 run of the train CLI: two steps on each rank, and
    the files under the run's directory written by rank 0 (metrics, the
    stats cache, the d-vectors, the checkpoints and ``latest``). Rank 1
    writes only the feature-cache files of its own shard's utterances
    (atomically, each through a temporary file), never a path rank 0
    writes."""
    r0, r1 = world.cli
    assert r0["steps"] == r1["steps"] == 2
    assert r0["optimizer"] == r1["optimizer"] == "ZeroRedundancyOptimizer"
    features = str(world.run / "cache" / "features")
    assert all(w.split(" ", 1)[1].startswith(features) for w in r1["writes"]), r1["writes"]
    final = [{w.split(" ", 1)[1] for w in r["writes"] if w.startswith("os.rename ")}
             for r in (r0, r1)]
    assert final[1] and not final[0] & final[1]
    wrote = "\n".join(r0["writes"])
    for part in ("logs/metrics.jsonl", "ckpt/latest", "ckpt/step_00000001/tree.pt",
                 "ckpt/step_00000002/sidecar.json", "cache/stats_", "cache/features",
                 "eval_examples", "corpus/spk0/speaker."):
        assert part in wrote, part
    lines = [json.loads(l) for l in (world.run / "logs" / "metrics.jsonl").read_text()
             .splitlines()]
    assert [l["step"] for l in lines if "train/total_loss" in l] == [0, 1]
    assert (world.run / "ckpt" / "latest").read_text() == "step_00000002"
    # the logged losses are the global batch's: the same on both ranks
    for h0, h1 in zip(r0["history"], r1["history"]):
        assert {k: v for k, v in h0.items() if k != "steps_per_s"} == \
            {k: v for k, v in h1.items() if k != "steps_per_s"}


def _restored(world):
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.train.loop import build_model

    args = cli.build_parser().parse_args(world.argv)
    cfg = cli.args_to_config(args)
    tree, _, side = Checkpointer(world.run / "ckpt").restore()
    ds = tds.TTSDataset(Path(args.train_target_path), cli.data_config(args, cfg),
                        cache_dir=Path(args.cache_path), device="cpu",
                        speaker2dvector=side["speaker2dvector"])
    model = build_model(cfg, ds, device="cpu")
    model.load_state_dict(tree["params"])
    return cfg, ds, model, tree


def test_cli_eval_is_the_whole_validation_set(world):
    """Every rank's eval metrics are those of the whole validation set: the
    two ranks agree exactly, and one process evaluating the checkpoint on
    the whole set agrees within f32 rounding."""
    from lightningfastspeech2_tpu_torch.train.loop import evaluate

    r0, r1 = world.cli
    assert len(r0["evals"]) == 2 and r0["evals"] == r1["evals"]
    cfg, ds, model, _ = _restored(world)
    valid = ds.create_validation_dataset(Path(world.argv[world.argv.index(
        "--valid_target_path") + 1]))
    got = evaluate(cfg, valid, model)
    assert set(got) == set(r0["evals"][-1])
    for k, v in got.items():
        np.testing.assert_allclose(r0["evals"][-1][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_zero1_checkpoint_resumes_in_one_process(world):
    """The ZeRO-1 run's checkpoint holds a plain AdamW state: it loads into
    one process's AdamW, and the third step taken there equals the third
    step the two ranks took from their live state."""
    from lightningfastspeech2_tpu_torch.train.optim import noam_lr
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg, _, model, tree = _restored(world)
    assert tree["step"] == 2
    state = create_train_state(model, cfg)
    assert type(state.optimizer) is torch.optim.AdamW
    state.optimizer.load_state_dict(tree["opt_state"])
    state.step = tree["step"]
    assert len(state.optimizer.state) == len(list(model.parameters()))
    z = np.load(world.work / "rank0_third_step.npz")
    batch = {k[7:]: z[k] for k in z.files if k.startswith("batch::")}
    state, metrics = make_train_step(model, cfg)(state, batch, torch.Generator().manual_seed(0))
    for k, v in world.cli[0]["third_step"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=ROUND_RTOL, atol=ROUND_ATOL,
                                   err_msg=k)
    # an element whose gradient is float noise (the key bias's true
    # gradient is 0) moves by an arbitrary fraction of lr: 1 % of lr
    lr = noam_lr(cfg.train.lr, cfg.train.warmup_steps, 2)
    live = model.state_dict()
    for k in z.files:
        if k.startswith("param::"):
            np.testing.assert_allclose(live[k[7:]].numpy(), z[k], rtol=ROUND_RTOL,
                                       atol=0.01 * lr, err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("data,model", [(-1, 1), (-1, 2), (2, 1), (2, 2)])
def test_mesh_layout_matches_jax(n, data, model):
    """``make_mesh``'s layout (ranks as the JAX mesh's device ids) and its
    errors against the JAX package's on 1, 2, 4 and 8 devices."""
    import jax

    from lightningfastspeech2_tpu.core import config as JC
    from lightningfastspeech2_tpu.parallel import mesh as jmesh

    try:
        ref = np.vectorize(lambda d: d.id)(jmesh.make_mesh(JC.MeshConfig(data=data, model=model),
                                                           devices=jax.devices()[:n]).devices)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{e}$"):
            mesh_lib.make_mesh(TC.MeshConfig(data=data, model=model), n)
        return
    got = mesh_lib.make_mesh(TC.MeshConfig(data=data, model=model), n)
    np.testing.assert_array_equal(got.devices, ref)
    assert (got.data, got.model) == ref.shape and got.data_group is None


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [8, 6, 3])
def test_host_local_batch_size_matches_jax(monkeypatch, n, batch):
    import jax

    from lightningfastspeech2_tpu.parallel import mesh as jmesh

    monkeypatch.setattr(jax, "process_count", lambda: n)
    try:
        ref = jmesh.host_local_batch_size(batch)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{e}$"):
            mesh_lib.host_local_batch_size(batch, n)
        return
    assert mesh_lib.host_local_batch_size(batch, n) == ref


def test_data_axis_halves_to_divide_the_batch():
    """The JAX CLI's halving of the data axis (``cli/train.py:376-389``)."""
    halve = mesh_lib.data_axis_for_batch
    assert halve(TC.MeshConfig(), 8, 8) == 8
    assert halve(TC.MeshConfig(), 8, 12) == 4
    assert halve(TC.MeshConfig(), 8, 3) == 1
    assert halve(TC.MeshConfig(model=2), 8, 6) == 2
    assert halve(TC.MeshConfig(data=4), 8, 2) == 2


def test_shard_and_common_bucket(tmp_path):
    """``shard_across_hosts`` keeps the data rank's strided slice (a model
    group's ranks the same one), and ``pad_to_bucket`` pads a collated
    share to the larger bucket exactly as ``collate`` pads it there."""
    from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
    from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus

    corpus = make_corpus(tmp_path / "c", n_speakers=2, n_utts=3, seed=1)
    dcfg = tds.DataConfig(variances=("pitch", "energy"), variance_levels=("frame", "phone"),
                          variance_transforms=("cwt", "none"), augment_duration=0.0)
    ds = tds.TTSDataset(corpus, dcfg, device="cpu")
    ids = [e.utt_id for e in ds.entries]
    for r in range(4):
        mesh = mesh_lib.Mesh(np.arange(4).reshape(2, 2), rank=r)
        shard = copy.copy(ds).shard_across_hosts(mesh)
        assert [e.utt_id for e in shard.entries] == ids[r // 2::2]
    assert [e.utt_id for e in ds.entries] == ids
    small = Bucketer(dcfg.max_phones, dcfg.max_frames, phone_step=8, frame_step=64)
    items = [ds[i] for i in range(len(ds))]
    short = min(items, key=lambda i: len(i["phones"]))
    alone = ds.collate([short], small)
    want = ds.collate([short, max(items, key=lambda i: i["mel"].shape[0])], small)
    P, T = tds.batch_buckets(want, dcfg)
    assert tds.batch_buckets(alone, dcfg) != (P, T)
    padded = tds.pad_to_bucket(alone, dcfg, P, T)
    for k, v in padded.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k])[:1], err_msg=k)
