"""Train the neural G2P model for out-of-vocabulary words on a CMUdict-format
lexicon.

Counterpart of ``scripts/train_g2p.py``: the same flags and defaults (a
seeded random or stem-disjoint holdout, then word accuracy and phone error
rate on it), plus ``--device`` (``cuda`` unless ``cpu``):

    python -m lightningfastspeech2_tpu_torch.cli.train_g2p \\
        --lexicon lightningfastspeech2_tpu_torch/data/lexicon_en_expanded.txt --out g2p.npz
    python -m lightningfastspeech2_tpu_torch.cli.generate --g2p_model g2p.npz ...

The bundle it writes is the JAX package's format, which both packages load.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Sequence, Tuple

import numpy as np

STEM_SUFFIXES = ("ingly", "edly", "ings", "tion", "ness", "ment", "able", "ing", "est", "ers",
                 "ies", "ed", "er", "es", "ly", "s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="neural G2P training (PyTorch / CUDA)")
    p.add_argument("--lexicon", required=True, help="CMUdict-format file (WORD  PH1 PH2 ...)")
    p.add_argument("--out", default="g2p.npz")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--d", type=int, default=96)
    p.add_argument("--holdout", type=int, default=500,
                   help="words held out to report generalization accuracy")
    p.add_argument("--holdout_mode", choices=("random", "stem"), default="random",
                   help="'stem' holds out whole suffix-stripped stem groups, so no "
                        "inflection of a held word is seen in training")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def stem(w: str) -> str:
    for suf in STEM_SUFFIXES:
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def split_holdout(lexicon: Dict[str, List[str]], holdout: int,
                  mode: str) -> Tuple[List[str], Dict[str, List[str]]]:
    """(held words, training lexicon): a seeded random holdout, or (``stem``)
    whole stem groups, drawn from ``np.random.default_rng(0)``."""
    words = sorted(lexicon)
    rng = np.random.default_rng(0)
    if mode == "stem":
        groups: Dict[str, List[str]] = {}
        for w in words:
            groups.setdefault(stem(w), []).append(w)
        keys = sorted(groups)
        held: List[str] = []
        for gi in rng.permutation(len(keys)):
            if len(held) >= holdout:
                break
            held.extend(groups[keys[gi]])
        hset = set(held)
        return held, {w: lexicon[w] for w in words if w not in hset}
    held_idx = set(rng.choice(len(words), size=min(holdout, len(words)),
                              replace=False).tolist())
    held = [w for i, w in enumerate(words) if i in held_idx]
    return held, {w: lexicon[w] for i, w in enumerate(words) if i not in held_idx}


def edit_distance(a: Sequence[str], b: Sequence[str]) -> int:
    dp = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        prev, dp[0] = dp[0], i
        for j in range(1, len(b) + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[len(b)]


def main(argv=None) -> dict:
    """Trains, saves ``--out``, scores the holdout; returns the held-out word
    accuracy and PER, the number of held words and every step's loss."""
    args = build_parser().parse_args(argv)
    from lightningfastspeech2_tpu_torch.core.device import f32_convolutions, resolve_device
    from lightningfastspeech2_tpu_torch.synthesis.g2p import EnglishG2P
    from lightningfastspeech2_tpu_torch.synthesis.neural_g2p import train_neural_g2p

    f32_convolutions("32")
    device = resolve_device(args.device)
    lexicon = EnglishG2P(args.lexicon).lexicon
    print(f"{len(lexicon)} lexicon entries")
    held, train_lex = split_holdout(lexicon, args.holdout, args.holdout_mode)
    if args.holdout_mode == "stem":
        print(f"stem-disjoint holdout: {len(held)} words across "
              f"{len({stem(w) for w in held})} stem groups; no shared stems with training")
    losses: list = []
    model = train_neural_g2p(train_lex, steps=args.steps, batch_size=args.batch_size, lr=args.lr,
                             d=args.d, verbose=True, device=device, losses=losses)
    model.save(args.out)
    print(f"saved {args.out}")
    result = {"held": len(held), "losses": losses}
    if held:
        preds = model(held)
        result["word_accuracy"] = sum(p == lexicon[w] for w, p in zip(held, preds)) / len(held)
        dist = sum(edit_distance(p, lexicon[w]) for w, p in zip(held, preds))
        result["per"] = dist / max(sum(len(lexicon[w]) for w in held), 1)
        print(f"held-out ({args.holdout_mode}): word accuracy {result['word_accuracy']:.3f}, "
              f"PER {result['per']:.3f} ({len(held)} words)")
    return result


if __name__ == "__main__":
    main()
