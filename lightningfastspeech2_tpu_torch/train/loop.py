"""Host-side training loop: dataset -> bucketed batches -> train steps.

Counterpart of ``lightningfastspeech2_tpu/train/loop.py`` (the reference's
Lightning ``Trainer.fit`` spine, ``litfass/train.py:285-292``): the same
batch order (``data/loader.py batch_index_stream``, through a
``PrefetchLoader`` when ``num_workers > 0``), gradient accumulation over a
leading micro-batch axis, the teacher-forcing draw per step, the interval
``steps_per_s``, ``lr`` at the step count after the update, and
checkpoints, evals and the freezing of variance encoders on the JAX
schedule. Metrics go to a pluggable ``log_fn`` (train/metrics_logger.py),
checkpoints through ``checkpoint_fn`` (core/checkpoint.py).

The model holds its parameters, so ``evaluate`` takes the model, and
``restore_encoder_params`` works on state dicts.

Under a ``mesh`` that splits the batch (parallel/mesh.py; the train CLI
under ``torch.distributed.run``) each data rank loads ``batch_size / data``
items a micro-batch from its shard of the corpus (``local_batch_size``),
the ranks pad each step's batch to their common bucket (``common_bucket``:
the JAX package's global batch has one shape, and the CWT's recompose
normalizes over the whole bucket), and the step reduces over the ranks
(train/step.py). Every rank draws the same teacher-forcing branch; the
dropout and stochastic-module streams differ by data rank, as the global
batch's items draw apart in the JAX step. ``evaluate`` gathers the outputs
over the data ranks, so every rank's metrics are the whole validation
set's; media go from rank 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
from lightningfastspeech2_tpu_torch.core.config import Config, replace
from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.models.draws import Draws, ModuleStreams
from lightningfastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from lightningfastspeech2_tpu_torch.models.variance_adaptor import StatsTree, VarianceStats
from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib
from lightningfastspeech2_tpu_torch.train.optim import noam_lr
from lightningfastspeech2_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)


def stats_tree(dataset, names) -> StatsTree:
    return tuple((name, VarianceStats(**s) if (s := (dataset.stats or {}).get(name))
                  else VarianceStats()) for name in names)


def prior_stats_tree(dataset, priors) -> StatsTree:
    return tuple((name, VarianceStats(**s) if (s := (dataset.stats or {}).get(f"priors_{name}"))
                  else VarianceStats()) for name in priors)


def build_model(cfg: Config, dataset, device: DeviceLike = None) -> FastSpeech2:
    """The model against the dataset's vocab and statistics, its weights
    drawn from ``cfg.train.seed``, on ``device`` (``cuda`` unless
    ``"cpu"``), in the working dtype of ``cfg.train.bf16``; with
    ``fastdiff_vocoder`` the joint acoustic + FastDiff module."""
    mcfg = cfg.model
    vocab_size = max(len(dataset.vocab), 2)
    if mcfg.vocab_size != vocab_size:
        mcfg = replace(mcfg, vocab_size=vocab_size)
    dtype = torch.bfloat16 if cfg.train.bf16 else torch.float32
    stats = stats_tree(dataset, mcfg.variance.variances)
    prior_stats = prior_stats_tree(dataset, mcfg.priors)
    generator = torch.Generator().manual_seed(cfg.train.seed)
    if mcfg.fastdiff_vocoder:
        # the joint acoustic + FastDiff module (the reference wires the
        # vocoder inside its LightningModule, fastspeech2.py:390-411)
        from lightningfastspeech2_tpu_torch.models.joint import (
            JointFastSpeech2FastDiff,
            make_fastdiff_config,
        )

        return JointFastSpeech2FastDiff(mcfg, make_fastdiff_config(mcfg), stats, prior_stats,
                                        dtype, device, generator)
    return FastSpeech2(mcfg, stats, prior_stats, dtype, device, generator)


def batch_iterator(dataset, batch_size: int, bucketer: Optional[Bucketer] = None,
                   shuffle: bool = True, seed: int = 0, epochs: Optional[int] = None,
                   sort_by_length: bool = False) -> Iterator[Dict[str, Any]]:
    """Collated batches, forever (or for ``epochs``), computed in this
    process; ``data.loader.PrefetchLoader`` gives the same order from
    worker processes."""
    from lightningfastspeech2_tpu_torch.data.loader import batch_index_stream

    lengths = None
    if sort_by_length:
        lengths = np.asarray([int(e.durations.sum()) for e in dataset.entries])
    for idx in batch_index_stream(len(dataset), batch_size, shuffle, seed, epochs, lengths):
        yield dataset.collate([dataset[i] for i in idx], bucketer)


class StopTraining(Exception):
    """Raised by an eval_fn to end training early (EarlyStopping analog,
    reference train.py:275-280)."""


def local_batch_size(cfg: Config, mesh=None) -> int:
    """The items a rank loads a micro-batch: ``cfg.train.batch_size`` is the
    global batch, split over the mesh's data ranks (the JAX package's
    ``local_batch_size``)."""
    if mesh is None:
        return cfg.train.batch_size
    return mesh_lib.host_local_batch_size(cfg.train.batch_size, mesh.data)


def common_bucket(batch: Dict[str, Any], data_cfg, mesh) -> Dict[str, Any]:
    """A collated batch padded to the largest phone and frame buckets of the
    data ranks (one small all-reduce), so that the ranks' shares are one
    global batch of one shape. A no-op without a split batch."""
    if mesh is None or not mesh.sharded:
        return batch
    from lightningfastspeech2_tpu_torch.data.dataset import batch_buckets, pad_to_bucket

    return pad_to_bucket(batch, data_cfg, *mesh.max(batch_buckets(batch, data_cfg)))


def _component_prefix(var: str) -> str:
    return ("variance_adaptor.duration_predictor." if var == "duration"
            else f"variance_adaptor.encoders.{var}.")


def encoder_snapshot(model: torch.nn.Module, var: str) -> Dict[str, torch.Tensor]:
    """Host copies of one variance encoder's (or ``"duration"``: the
    duration predictor's) tensors, keyed relative to the component."""
    prefix = _component_prefix(var)
    return {k[len(prefix):]: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items() if k.startswith(prefix)}


def restore_encoder_params(params: Mapping[str, torch.Tensor],
                           restores: Mapping[str, Optional[Mapping[str, torch.Tensor]]]
                           ) -> Dict[str, torch.Tensor]:
    """``params`` (a model state dict) with each restored component's
    snapshot written back: ``variance_adaptor.encoders.{var}.*``, or
    ``variance_adaptor.duration_predictor.*`` for ``"duration"`` (reference
    load_state_dict of {key}_encoder_best.pt, fastspeech2.py:1097-1115)."""
    out = dict(params)
    for var, snap in restores.items():
        if snap is None:
            continue
        prefix = _component_prefix(var)
        for key, value in snap.items():
            if prefix + key in out:
                out[prefix + key] = value
    return out


@dataclass
class TrainResult:
    state: TrainState
    history: List[Dict[str, float]]
    # the stochastic-weight-averaged parameters when cfg.train.swa is on
    # (reference train.py:282-283 StochasticWeightAveraging callback)
    swa_params: Optional[Dict[str, torch.Tensor]] = None
    # host seconds of the loop, of them waiting for a batch, and of those
    # waiting for the first (a loader's workers starting)
    loop_s: float = 0.0
    loader_wait_s: float = 0.0
    first_batch_s: float = 0.0


def _host(x) -> np.ndarray:
    """A tensor or array as a float or bool numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x if x.dtype == torch.bool else x.float()).cpu().numpy()
    return np.asarray(x)


@torch.no_grad()
def evaluate(cfg: Config, dataset, model: FastSpeech2, max_batches: int = 8,
             media_dir=None, step: int = 0, vocoder: Optional[Callable] = None,
             max_examples: int = 10, mesh=None) -> Dict[str, float]:
    """Validation pass (reference validation_step + epoch end,
    ``fastspeech2.py:799-827,998-1163``): the teacher-forced losses and an
    inference forward of up to ``max_batches`` batches in eval mode, then
    the KDE-JS / MAE / MCD / soft-DTW metrics. Each batch's outputs come to
    the host once. With ``media_dir`` the first ``max_examples`` pred/true
    mels are written there (and, with a ``vocoder``, their audio), by rank
    0. Under a ``mesh`` that splits the batch, ``dataset`` is this rank's
    shard: the ranks run the same number of batches (the shortest shard's),
    each global batch's losses come from the eval step, and its host
    outputs are gathered in data-rank order, as the JAX package's
    replicated eval outputs hold the global batch."""
    from lightningfastspeech2_tpu_torch.train.metrics import eval_metrics

    bucketer = Bucketer(cfg.model.max_phones, cfg.model.max_frames)
    eval_step = make_eval_step(model, cfg, mesh)
    sharded = mesh is not None and mesh.sharded
    batch_size = local_batch_size(cfg, mesh)
    if sharded:
        max_batches = mesh.min([min(max_batches, len(dataset) // batch_size)])[0]
    vcfg = cfg.model.variance
    variances = vcfg.variances
    accum: Dict[str, List[np.ndarray]] = {}
    losses_sum: Dict[str, float] = {}
    n_batches = 0
    batches = batch_iterator(dataset, batch_size, bucketer, shuffle=False,
                             epochs=1) if max_batches > 0 else iter(())
    for batch in batches:
        if n_batches >= max_batches:
            break
        arrs = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
        arrs = common_bucket(arrs, getattr(dataset, "cfg", None), mesh)
        # feat carries the targets, those of a raw-wav batch too
        losses, out, out_inf, feat = eval_step(arrs)
        n_batches += 1
        # one transfer a batch: every tensor the metrics read
        keys = ["phone_mask", "frame_mask", "mel"] + [f"variances_{v}" for v in variances]
        host = {k: _host(out[k]) for k in keys if k in out}
        host_inf = {k: _host(out_inf[k]) for k in
                    ["frame_mask", "duration_rounded"] + [f"variances_{v}" for v in variances]
                    if k in out_inf}
        for k, v in losses.items():
            losses_sum[k] = losses_sum.get(k, 0.0) + float(v)
        part: Dict[str, List[np.ndarray]] = {}
        phone_mask, tf_mask = host["phone_mask"], host["frame_mask"]
        for i, var in enumerate(variances):
            if vcfg.transforms[i] == "cwt":
                continue   # distribution metrics use the scalar signals
            phone = vcfg.levels[i] == "phone"
            true_mask = phone_mask if phone else tf_mask
            true_full = _host(feat[f"variances_{var}"])
            part.setdefault(f"{var}_pred", []).append(
                host_inf[f"variances_{var}"][phone_mask if phone else host_inf["frame_mask"]])
            part.setdefault(f"{var}_true", []).append(
                true_full[:, : true_mask.shape[1]][true_mask])
            # teacher-forced predictions share the target's frame grid: the
            # MAE's aligned pairs (fastspeech2.py:1024-1056)
            part.setdefault(f"{var}_pred_tf", []).append(
                host[f"variances_{var}"][:, : true_mask.shape[1]][true_mask])
        part.setdefault("duration_pred", []).append(host_inf["duration_rounded"][phone_mask])
        part.setdefault("duration_true", []).append(
            _host(arrs["duration"])[:, : phone_mask.shape[1]][phone_mask])
        mel_pred, mel_true = host["mel"], _host(feat["mel"])
        for b in range(mel_pred.shape[0]):
            part.setdefault("mel_pred", []).append(mel_pred[b][tf_mask[b]])
            part.setdefault("mel_true", []).append(mel_true[b][: tf_mask[b].sum()])
        for rank_part in (mesh.gather(part) if sharded else [part]):
            for k, v in rank_part.items():
                accum.setdefault(k, []).extend(v)
    metrics = eval_metrics(accum, variances)
    for k, v in losses_sum.items():
        metrics[f"eval/{k}_loss"] = v / max(n_batches, 1)
    if media_dir is not None and mesh_lib.is_main():
        from lightningfastspeech2_tpu_torch.utils.plotting import save_eval_examples

        mels_pred = accum.get("mel_pred", [])[:max_examples]
        mels_true = accum.get("mel_true", [])[:max_examples]
        audios = None
        if vocoder is not None:
            audios = [np.asarray(vocoder(m), np.float32).reshape(-1) / 32768.0
                      for m in mels_pred]
        save_eval_examples(media_dir, step, mels_pred, mels_true, audios,
                           sampling_rate=cfg.model.audio.sampling_rate,
                           max_examples=max_examples)
    return metrics


def _step_generator(device: torch.device, seed: int, step_i: int,
                    data_rank: int = 0) -> torch.Generator:
    """The dropout and kernel-seed stream of step ``step_i`` on data rank
    ``data_rank``: a function of (seed, step, data rank) alone, as the JAX
    package's ``fold_in(PRNGKey(seed + 1), step)``."""
    return torch.Generator(device=device).manual_seed(((seed + 1) << 32) + step_i
                                                      + (data_rank << 48))


def _step_draws(seed: int, step_i: int, data_rank: int = 0) -> ModuleStreams:
    """The stochastic modules' draws of step ``step_i`` on data rank
    ``data_rank`` (the JAX package's ``sdp`` stream, ``fold_in(rng, 7)``):
    drawn on the CPU, so the card and the CPU train on the same values."""
    return ModuleStreams((((seed + 1) << 32) + step_i) * 8 + 7 + (data_rank << 52))


def fit(cfg: Config, dataset, max_steps: Optional[int] = None,
        log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
        checkpoint_fn: Optional[Callable[[int, TrainState], None]] = None,
        eval_fn: Optional[Callable[[int, TrainState], Any]] = None,
        state: Optional[TrainState] = None, device: DeviceLike = None,
        draws: Optional[Draws] = None, mesh=None) -> TrainResult:
    """Train for ``max_steps`` (default ``cfg.train.max_steps``) optimizer
    steps from ``state`` (default: ``build_model`` on ``device`` and a fresh
    AdamW, ZeRO-1 under ``cfg.train.zero1`` and a split batch). The
    stochastic modules draw from each step's own streams (``_step_draws``),
    or from ``draws`` for all steps where given. Under a ``mesh``,
    ``dataset`` is this rank's shard and every rank calls ``fit``. The
    loader's workers, when there are any, are closed on every way out."""
    if state is None:
        state = create_train_state(build_model(cfg, dataset, device=resolve_device(device)), cfg,
                                   mesh)
    bucketer = Bucketer(cfg.model.max_phones, cfg.model.max_frames)
    max_steps = max_steps or cfg.train.max_steps
    accum = max(cfg.train.grad_accum, 1)
    batch_size = local_batch_size(cfg, mesh)
    loader = None
    if cfg.train.num_workers > 0:
        from lightningfastspeech2_tpu_torch.data.loader import PrefetchLoader

        loader = PrefetchLoader(dataset, batch_size * accum, bucketer,
                                seed=cfg.train.seed, num_workers=cfg.train.num_workers,
                                prefetch=cfg.train.prefetch, device=dataset.device)
        batches = iter(loader)
    else:
        batches = batch_iterator(dataset, batch_size * accum, bucketer, seed=cfg.train.seed)
    try:
        return _fit_loop(cfg, state, batches, accum, max_steps, log_fn, checkpoint_fn, eval_fn,
                         len(dataset), draws, mesh, getattr(dataset, "cfg", None))
    finally:
        if loader is not None:
            loader.close()


def _fit_loop(cfg: Config, state: TrainState, batches, accum: int, max_steps: int,
              log_fn, checkpoint_fn, eval_fn, len_dataset: int = 1,
              draws: Optional[Draws] = None, mesh=None, data_cfg=None) -> TrainResult:
    model = state.model
    step_fn = make_train_step(model, cfg, mesh)
    batch_size = local_batch_size(cfg, mesh)
    data_rank = 0 if mesh is None else mesh.data_rank
    schedule_fn = None
    if cfg.model.fastdiff_vocoder:
        # the epoch-indexed P(condition the vocoder on the predicted mel)
        # (reference fastspeech2.py:403-411); as in the JAX package, an
        # epoch is this rank's shard over the global batch
        from lightningfastspeech2_tpu_torch.models.joint import schedule_probability

        steps_per_epoch = max(len_dataset // (cfg.train.batch_size * accum), 1)
        schedule_fn = lambda s: schedule_probability(cfg.model, s // steps_per_epoch)
    swa = None
    if cfg.train.swa:
        from lightningfastspeech2_tpu_torch.train.swa import SWA

        swa = SWA(start_step=int(max_steps * cfg.train.swa_start_pct))
    history: List[Dict[str, float]] = []
    frozen: Tuple[str, ...] = ()
    t_start = time.perf_counter()
    batch = next(batches)
    first_s = wait_s = time.perf_counter() - t_start
    rate_anchor = (0, t_start)
    for step_i in range(max_steps):
        arrs = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
        arrs = common_bucket(arrs, data_cfg, mesh)
        if accum > 1:
            arrs = {k: v.reshape((accum, batch_size) + tuple(v.shape[1:]))
                    for k, v in arrs.items()}
        tf = True
        if cfg.model.tf_ratio < 1.0:
            # the teacher-forcing draw of this step (model.py:272)
            tf = bool(np.random.default_rng(cfg.train.seed + step_i).uniform()
                      <= cfg.model.tf_ratio)
        kwargs = {} if schedule_fn is None else {"schedule_p": schedule_fn(step_i)}
        state, metrics = step_fn(state, arrs, _step_generator(model.device, cfg.train.seed,
                                                               step_i, data_rank),
                                 tf=tf, frozen=frozen,
                                 draws=(draws if draws is not None
                                        else _step_draws(cfg.train.seed, step_i, data_rank)),
                                 **kwargs)
        if swa is not None:
            swa.update(step_i, dict(model.named_parameters()))
        if step_i % cfg.train.log_every == 0 or step_i == max_steps - 1:
            snap = {k: float(v) for k, v in metrics.items()}
            # the rate since the last log line, not since the start, which
            # start-up would dilute for thousands of steps
            now = time.perf_counter()
            prev_step, prev_t = rate_anchor
            snap["steps_per_s"] = (step_i + 1 - prev_step) / max(now - prev_t, 1e-9)
            rate_anchor = (step_i + 1, now)
            snap["lr"] = noam_lr(cfg.train.lr, cfg.train.warmup_steps, step_i + 1)
            history.append(snap)
            if log_fn:
                log_fn(step_i, snap)
        if checkpoint_fn and (step_i + 1) % cfg.train.checkpoint_every == 0:
            checkpoint_fn(step_i, state)
        if eval_fn and (step_i + 1) % cfg.train.eval_every == 0:
            # eval_fn may return a new frozen tuple (variance early
            # stopping), optionally paired with {var: best encoder snapshot}
            # to write back before freezing (fastspeech2.py:1097-1115)
            try:
                ret = eval_fn(step_i, state)
            except StopTraining:
                break
            restores = {}
            if isinstance(ret, tuple) and len(ret) == 2 and isinstance(ret[1], dict):
                new_frozen, restores = ret
            else:
                new_frozen = ret
            if restores:
                model.load_state_dict(restore_encoder_params(model.state_dict(), restores))
            if new_frozen:
                frozen = tuple(new_frozen)
        if step_i + 1 < max_steps:
            t = time.perf_counter()
            batch = next(batches)
            wait_s += time.perf_counter() - t
    return TrainResult(state=state, history=history,
                       swa_params=None if swa is None else swa.params,
                       loop_s=time.perf_counter() - t_start, loader_wait_s=wait_s,
                       first_batch_s=first_s)
