"""Neural grapheme-to-phoneme model for out-of-vocabulary words: inference.

Counterpart of ``lightningfastspeech2_tpu/synthesis/neural_g2p.py``: a
2+2-layer transformer encoder/decoder over characters -> ARPABET phones,
greedy-decoded over fixed lengths (28 characters in, 36 phones out). It
loads the JAX package's ``.npz`` bundles (the shipped ``data/g2p_en.npz``,
or one that ``scripts/train_g2p.py`` wrote): ``meta`` is JSON, ``params``
the bytes of ``flax.serialization.to_bytes``, decoded by
``utils/flax_msgpack.py``.

flax's conventions are kept: LayerNorm eps 1e-6; attention with query, key
and value kernels (d, 4, d/4) and an out kernel (4, d/4, d), the query
scaled by 1/sqrt(d/4), masked scores set to the f32 minimum (so a row with
no valid key takes a uniform softmax, not NaN). Decoding re-runs the
decoder over the whole token buffer at every step and takes the argmax
(first index on ties) at the step's position, as the JAX package's
``fori_loop`` does.

``train_neural_g2p`` trains one on a word -> phones dict as the JAX trainer
does (teacher-forced cross-entropy, AdamW with optax's defaults, batches
drawn by ``np.random.default_rng(seed)``), on the card unless asked for the
CPU; ``NeuralG2P.save`` writes the JAX package's bundle (the flax tree as
``to_bytes`` bytes, ``utils/flax_msgpack.py``), so either package loads
what the other wrote.

    g2p = NeuralG2P.load(BUILTIN_PATH)          # on the card
    g2p = NeuralG2P.load(BUILTIN_PATH, "cpu")
    g2p(["hello", "zyzzyva"])                   # [[...], [...]]
    train_neural_g2p(lexicon, device="cpu").save("g2p.npz")
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.utils import flax_msgpack

PAD, BOS, EOS = 0, 1, 2
MAX_WORD = 28    # characters
MAX_PHONES = 36  # output tokens (incl. EOS)
HEADS = 4
LN_EPS = 1e-6    # flax's LayerNorm default

BUILTIN_PATH = Path(__file__).resolve().parent.parent / "data" / "g2p_en.npz"


def _char_vocab() -> Dict[str, int]:
    chars = list("abcdefghijklmnopqrstuvwxyz'-.")
    return {c: i + 3 for i, c in enumerate(chars)}


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads=4, qkv_features=d)``
    with the four projections as (d, d) Linears."""

    def __init__(self, d: int, heads: int = HEADS):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(d, d) for _ in range(4))

    def forward(self, xq, xkv, mask):
        B, Tq, d = xq.shape
        h, dh = self.heads, d // self.heads
        q = self.query(xq).view(B, Tq, h, dh) / float(np.sqrt(dh))
        k = self.key(xkv).view(B, -1, h, dh)
        v = self.value(xkv).view(B, -1, h, dh)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.where(mask, w, torch.finfo(w.dtype).min)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(w, dim=-1), v)
        return self.out(o.reshape(B, Tq, d))


class _Block(nn.Module):
    def __init__(self, d: int, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.self_attn = _Attention(d)
        self.cross_attn = _Attention(d) if causal else None
        n_norms = 3 if causal else 2
        self.norms = nn.ModuleList(nn.LayerNorm(d, eps=LN_EPS) for _ in range(n_norms))
        self.dense0, self.dense1 = nn.Linear(d, 4 * d), nn.Linear(4 * d, d)

    def forward(self, x, mask, ctx=None, ctx_mask=None):
        T = x.shape[1]
        attn_mask = mask[:, None, None, :]
        if self.causal:
            tri = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            attn_mask = attn_mask & tri
        x = self.norms[0](x + self.self_attn(x, x, attn_mask))
        n = 1
        if ctx is not None:
            x = self.norms[1](x + self.cross_attn(x, ctx, ctx_mask[:, None, None, :]))
            n = 2
        h = self.dense1(F.relu(self.dense0(x)))
        return self.norms[n](x + h)


class G2PTransformer(nn.Module):
    """2+2-layer encoder/decoder; ~400k params at d=96."""

    def __init__(self, n_chars: int, n_phones: int, d: int = 96, layers: int = 2):
        super().__init__()
        self.d = d
        self.char_emb = nn.Embedding(n_chars, d)
        self.phone_emb = nn.Embedding(n_phones, d)
        self.pos_enc = nn.Parameter(torch.zeros(max(MAX_WORD, MAX_PHONES), d))
        self.enc_blocks = nn.ModuleList(_Block(d) for _ in range(layers))
        self.dec_blocks = nn.ModuleList(_Block(d, causal=True) for _ in range(layers))
        self.head = nn.Linear(d, n_phones)

    def encode(self, chars):
        mask = chars != PAD
        x = self.char_emb(chars) + self.pos_enc[: chars.shape[1]]
        for blk in self.enc_blocks:
            x = blk(x, mask)
        return x, mask

    def decode(self, tokens, enc, enc_mask):
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
        x = self.phone_emb(tokens) + self.pos_enc[: tokens.shape[1]]
        for blk in self.dec_blocks:
            x = blk(x, mask, enc, enc_mask)
        return self.head(x)

    def forward(self, chars, tokens):
        enc, enc_mask = self.encode(chars)
        return self.decode(tokens, enc, enc_mask)


def flax_state_dict(params: Mapping, layers: int = 2) -> Dict[str, np.ndarray]:
    """The flax ``G2PTransformer`` tree (with or without its ``params`` key)
    -> this module's state dict. Dense kernels (in, out) -> Linear (out,
    in); attention kernels (d, H, d/H) and (H, d/H, d) -> (d, d)."""
    t = params.get("params", params)
    out: Dict[str, np.ndarray] = {
        "char_emb.weight": t["char_emb"]["embedding"],
        "phone_emb.weight": t["phone_emb"]["embedding"],
        "pos_enc": t["pos_enc"],
        "head.weight": np.asarray(t["head"]["kernel"]).T,
        "head.bias": t["head"]["bias"],
    }

    def attn(prefix, p):
        for name in ("query", "key", "value"):
            k = np.asarray(p[name]["kernel"])
            out[f"{prefix}.{name}.weight"] = k.reshape(k.shape[0], -1).T
            out[f"{prefix}.{name}.bias"] = np.asarray(p[name]["bias"]).reshape(-1)
        k = np.asarray(p["out"]["kernel"])
        out[f"{prefix}.out.weight"] = k.reshape(-1, k.shape[-1]).T
        out[f"{prefix}.out.bias"] = p["out"]["bias"]

    for kind, n_norms in (("enc", 2), ("dec", 3)):
        for i in range(layers):
            b, p = f"{kind}_blocks.{i}", t[f"{kind}_blocks_{i}"]
            attn(f"{b}.self_attn", p["MultiHeadDotProductAttention_0"])
            if kind == "dec":
                attn(f"{b}.cross_attn", p["MultiHeadDotProductAttention_1"])
            for j in range(n_norms):
                out[f"{b}.norms.{j}.weight"] = p[f"LayerNorm_{j}"]["scale"]
                out[f"{b}.norms.{j}.bias"] = p[f"LayerNorm_{j}"]["bias"]
            for j in range(2):
                out[f"{b}.dense{j}.weight"] = np.asarray(p[f"Dense_{j}"]["kernel"]).T
                out[f"{b}.dense{j}.bias"] = p[f"Dense_{j}"]["bias"]
    return out


def flax_tree(state: Mapping[str, torch.Tensor], layers: int = 2) -> Dict[str, Dict]:
    """This module's state dict -> the flax ``G2PTransformer`` variables
    ``{"params": ...}`` (``flax_state_dict``'s inverse), f32 numpy."""
    a = {k: v.detach().float().cpu().numpy() for k, v in state.items()}
    heads = HEADS
    t: Dict[str, Dict] = {
        "char_emb": {"embedding": a["char_emb.weight"]},
        "phone_emb": {"embedding": a["phone_emb.weight"]},
        "pos_enc": a["pos_enc"],
        "head": {"kernel": np.ascontiguousarray(a["head.weight"].T), "bias": a["head.bias"]},
    }

    def attn(prefix):
        out = {}
        for name in ("query", "key", "value"):
            w = a[f"{prefix}.{name}.weight"]                          # (out, in)
            out[name] = {"kernel": np.ascontiguousarray(w.T.reshape(w.shape[1], heads, -1)),
                         "bias": a[f"{prefix}.{name}.bias"].reshape(heads, -1)}
        w = a[f"{prefix}.out.weight"]
        out["out"] = {"kernel": np.ascontiguousarray(w.T.reshape(heads, -1, w.shape[0])),
                      "bias": a[f"{prefix}.out.bias"]}
        return out

    for kind, n_norms in (("enc", 2), ("dec", 3)):
        for i in range(layers):
            b = f"{kind}_blocks.{i}"
            p = {"MultiHeadDotProductAttention_0": attn(f"{b}.self_attn")}
            if kind == "dec":
                p["MultiHeadDotProductAttention_1"] = attn(f"{b}.cross_attn")
            for j in range(n_norms):
                p[f"LayerNorm_{j}"] = {"scale": a[f"{b}.norms.{j}.weight"],
                                       "bias": a[f"{b}.norms.{j}.bias"]}
            for j in range(2):
                p[f"Dense_{j}"] = {"kernel": np.ascontiguousarray(a[f"{b}.dense{j}.weight"].T),
                                   "bias": a[f"{b}.dense{j}.bias"]}
            t[f"{kind}_blocks_{i}"] = p
    return {"params": t}


@torch.no_grad()
def init_weights(model: G2PTransformer, generator: torch.Generator) -> None:
    """flax's initializers for ``G2PTransformer``, drawn on the CPU from
    ``generator`` (flax's own draws cannot be reproduced): embeddings
    N(0, 1/d), ``pos_enc`` N(0, 0.02^2), every kernel LeCun normal
    (fan_in = its input width), biases 0, LayerNorms 1 and 0."""
    from lightningfastspeech2_tpu_torch.utils.convert import lecun_normal_

    for emb in (model.char_emb, model.phone_emb):
        emb.weight.copy_(torch.randn(emb.weight.shape, generator=generator)
                         * emb.weight.shape[1] ** -0.5)
    model.pos_enc.copy_(torch.randn(model.pos_enc.shape, generator=generator) * 0.02)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.weight.shape[1], generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class NeuralG2P:
    """Inference wrapper: word strings -> ARPABET phone lists, on the
    model's device, with a per-word cache."""

    def __init__(self, model: G2PTransformer, char2id: Dict[str, int],
                 phone_list: Sequence[str]):
        self.model = model.eval()
        self.char2id = dict(char2id)
        self.phone_list = list(phone_list)
        self._cache: Dict[str, List[str]] = {}

    @property
    def device(self) -> torch.device:
        return self.model.head.weight.device

    def encode_word(self, word: str) -> np.ndarray:
        ids = [self.char2id[c] for c in word.lower() if c in self.char2id]
        ids = ids[:MAX_WORD]
        return np.asarray(ids + [PAD] * (MAX_WORD - len(ids)), np.int64)

    @torch.no_grad()
    def decode_ids(self, chars: np.ndarray) -> np.ndarray:
        """Greedy decode of (B, MAX_WORD) character ids -> (B, MAX_PHONES)
        token ids (EOS / PAD end a word)."""
        c = torch.as_tensor(chars, dtype=torch.long, device=self.device)
        enc, enc_mask = self.model.encode(c)
        toks = torch.full((c.shape[0], MAX_PHONES + 1), PAD, dtype=torch.long,
                          device=self.device)
        toks[:, 0] = BOS
        for i in range(MAX_PHONES):
            logits = self.model.decode(toks[:, :-1], enc, enc_mask)
            toks[:, i + 1] = logits[:, i].argmax(dim=-1)
        return toks[:, 1:].cpu().numpy()

    def __call__(self, words: Sequence[str]) -> List[List[str]]:
        out: List[Optional[List[str]]] = [self._cache.get(w) for w in words]
        todo = [i for i, o in enumerate(out) if o is None]
        if todo:
            toks = self.decode_ids(np.stack([self.encode_word(words[i]) for i in todo]))
            for row, i in enumerate(todo):
                phones: List[str] = []
                for t in toks[row]:
                    if t in (EOS, PAD):
                        break
                    if t >= 3:
                        phones.append(self.phone_list[int(t) - 3])
                out[i] = phones
                self._cache[words[i]] = phones
        return out  # type: ignore[return-value]

    def save(self, path) -> None:
        """The JAX package's bundle: ``params`` the flax tree's ``to_bytes``
        bytes, ``meta`` JSON of the vocabularies and the width."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tree = flax_tree(self.model.state_dict(), layers=len(self.model.enc_blocks))
        np.savez(path, params=np.frombuffer(flax_msgpack.to_bytes(tree), np.uint8),
                 meta=json.dumps({"char2id": self.char2id, "phone_list": self.phone_list,
                                  "d": self.model.d}))

    @classmethod
    def load(cls, path=BUILTIN_PATH, device: DeviceLike = None) -> "NeuralG2P":
        """A bundle the JAX package's ``NeuralG2P.save`` wrote, on ``device``
        (``cuda`` unless ``"cpu"``)."""
        dev = resolve_device(device)
        data = np.load(Path(path), allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        model = G2PTransformer(n_chars=len(meta["char2id"]) + 3,
                               n_phones=len(meta["phone_list"]) + 3, d=meta["d"])
        params = flax_msgpack.restore(data["params"].tobytes())
        state = flax_state_dict(params, layers=len(model.enc_blocks))
        model.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                               for k, v in state.items()})
        return cls(model.to(dev), meta["char2id"], meta["phone_list"])


def _prepare_dataset(lexicon: Dict[str, List[str]], char2id: Dict[str, int],
                     phone2id: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static-shape (chars, dec_in, dec_target) arrays; words whose
    characters or phones are unknown or too long are skipped."""
    xs, tin, tout = [], [], []
    for word, phones in lexicon.items():
        cids = [char2id[c] for c in word.lower() if c in char2id]
        pids = [phone2id[p] for p in phones if p in phone2id]
        if not cids or not pids:
            continue
        if len(cids) > MAX_WORD or len(pids) >= MAX_PHONES:
            continue
        xs.append(cids + [PAD] * (MAX_WORD - len(cids)))
        seq_in = [BOS] + pids
        seq_out = pids + [EOS]
        tin.append(seq_in + [PAD] * (MAX_PHONES - len(seq_in)))
        tout.append(seq_out + [PAD] * (MAX_PHONES - len(seq_out)))
    return (np.asarray(xs, np.int64), np.asarray(tin, np.int64),
            np.asarray(tout, np.int64))


def train_neural_g2p(lexicon: Dict[str, List[str]], steps: int = 3000, batch_size: int = 128,
                     lr: float = 1e-3, d: int = 96, seed: int = 0, verbose: bool = False,
                     device: DeviceLike = None,
                     init: Optional[Mapping[str, torch.Tensor]] = None,
                     losses: Optional[List[float]] = None) -> NeuralG2P:
    """Teacher-forced cross-entropy training on a word -> phones dict (the
    JAX package's ``train_neural_g2p``), on ``device`` (``cuda`` unless
    ``"cpu"``). AdamW as ``optax.adamw(lr)``: betas (0.9, 0.999), eps 1e-8
    and weight decay 1e-4 on every parameter (torch's default is 1e-2).
    Each step's batch indices come from ``np.random.default_rng(seed)``;
    the weights from ``init_weights`` on a ``torch.Generator`` seeded
    ``seed``, or from ``init`` (a state dict, e.g. a JAX run's first
    weights through ``flax_state_dict``). ``losses``, where given, gets
    every step's loss."""
    dev = resolve_device(device)
    char2id = _char_vocab()
    phone_list = sorted({p for ph in lexicon.values() for p in ph})
    phone2id = {p: i + 3 for i, p in enumerate(phone_list)}
    chars, tin, tout = _prepare_dataset(lexicon, char2id, phone2id)
    n = len(chars)
    if n == 0:
        raise ValueError("empty/unusable lexicon")
    model = G2PTransformer(n_chars=len(char2id) + 3, n_phones=len(phone_list) + 3, d=d)
    if init is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                               for k, v in init.items()})
    model.to(dev).train()
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    data = [torch.as_tensor(a, device=dev) for a in (chars, tin, tout)]
    rng = np.random.default_rng(seed)
    step_losses = []
    for step in range(steps):
        idx = torch.as_tensor(rng.integers(n, size=batch_size), device=dev)
        bc, bi, bo = (a[idx] for a in data)
        logits = model(bc, bi)
        mask = (bo != PAD).float()
        ce = F.cross_entropy(logits.transpose(1, 2), bo, reduction="none")
        loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        step_losses.append(loss.detach())
        if verbose and step % 200 == 0:
            print(f"g2p step {step}: loss {float(step_losses[-1]):.4f}", flush=True)
    if losses is not None and step_losses:
        losses.extend(torch.stack(step_losses).tolist())
    return NeuralG2P(model, char2id, phone_list)
