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
``fori_loop`` does. Training (``train_neural_g2p``) is not ported yet.

    g2p = NeuralG2P.load(BUILTIN_PATH)          # on the card
    g2p = NeuralG2P.load(BUILTIN_PATH, "cpu")
    g2p(["hello", "zyzzyva"])                   # [[...], [...]]
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

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
