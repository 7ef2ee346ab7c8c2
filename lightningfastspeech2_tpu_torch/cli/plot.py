"""Dataset item figures as PNGs.

Counterpart of ``lightningfastspeech2_tpu/cli/plot.py``, with its flags
plus ``--device``: scan an aligned corpus with the port's ``TTSDataset``
(features on the card unless ``--device cpu``), and write the first N
items' composite figures (``utils/plotting.py plot_item``: mel, phone
boundaries, variance curves, CWT panels, prior densities) as
``<output_path>/{speaker}_{utt_id}.png``. Needs neither matplotlib nor PIL.

    python -m lightningfastspeech2_tpu_torch.cli.plot \\
        --target_path corpus --output_path plots --n 4 \\
        --variances pitch energy --variance_transforms cwt none
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dataset item plots")
    p.add_argument("--target_path", type=str, required=True,
                   help="aligned corpus (wav + TextGrid pairs)")
    p.add_argument("--output_path", type=str, default="plots")
    p.add_argument("--n", type=int, default=4, help="number of items to render")
    p.add_argument("--variances", nargs="+", default=["pitch", "energy"])
    p.add_argument("--variance_levels", nargs="+", default=None,
                   help="default: frame for every variance")
    p.add_argument("--variance_transforms", nargs="+", default=None,
                   help="none|log|cwt per variance (default none)")
    p.add_argument("--priors", nargs="*", default=["pitch", "energy", "duration"])
    p.add_argument("--stat_entries", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the features are extracted")
    return p


def main(argv=None) -> list:
    """Writes the figures; returns their paths."""
    args = build_parser().parse_args(argv)
    from lightningfastspeech2_tpu_torch.data.dataset import DataConfig, TTSDataset
    from lightningfastspeech2_tpu_torch.utils.plotting import plot_item, png_bytes

    n_var = len(args.variances)
    levels = tuple(args.variance_levels or ["frame"] * n_var)
    transforms = tuple(args.variance_transforms or ["none"] * n_var)
    # a prior can only be computed for an extracted variance (or duration)
    prior_names = tuple(p for p in args.priors if p == "duration" or p in args.variances)
    cfg = DataConfig(variances=tuple(args.variances), variance_levels=levels,
                     variance_transforms=transforms, priors=prior_names,
                     stat_entries=args.stat_entries, augment_duration=0.0, seed=args.seed)
    ds = TTSDataset(root=Path(args.target_path), cfg=cfg, device=args.device)
    if len(ds) == 0:
        raise SystemExit(f"no usable utterances under {args.target_path}")

    out = Path(args.output_path)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for i in range(min(args.n, len(ds))):
        item = ds.__getitem__(i, augment=False)
        entry = ds.entries[i]
        variances, cwt_specs = {}, {}
        for var, level, tr in zip(args.variances, levels, transforms):
            if tr == "cwt":
                cwt_specs[var] = item[f"variances_{var}_spectrogram"]
            elif level == "frame":
                variances[var] = item[f"variances_{var}"]
            else:
                # phone level: expanded to the frame grid by the durations,
                # so that the curve still lies over the mel
                variances[var] = np.repeat(np.asarray(item[f"variances_{var}"]),
                                           np.asarray(item["duration"]))
        priors = {v: float(item[f"priors_{v}"]) for v in prior_names if f"priors_{v}" in item}
        img = plot_item(item["mel"], durations=np.asarray(item["duration"]),
                        phones=entry.phones, variances=variances, cwt_spectrograms=cwt_specs,
                        priors=priors,
                        prior_stats={v: ds.stats.get(f"priors_{v}", {}) for v in priors},
                        title=f"{entry.speaker}/{entry.utt_id}")
        path = out / f"{entry.speaker}_{entry.utt_id}.png"
        path.write_bytes(png_bytes(img))
        written.append(path)
        print(f"wrote {path}", flush=True)
    return written


if __name__ == "__main__":
    main()
