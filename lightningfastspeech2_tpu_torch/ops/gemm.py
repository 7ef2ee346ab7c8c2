"""The geometry of ``csrc/gemm_mma.cuh``'s product, which the wide routes
launch (``ops/ffn.py``'s chain at C = 384-768, ``ops/hifigan_resblock.py``'s
route past C = 256): 128 x 128 output tiles of 256 threads, K in chunks of
32 through two shared-memory stages, and the rows of K a block takes when
a product is split over K. The CUDA source checks nothing against this
module; the launches it records are held against the plans built here."""

from __future__ import annotations

import torch

TILE = 128      # kBM = kBN: output rows and columns a block owns
CHUNK = 32      # kBK: K a shared-memory stage holds
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM


def smem_bytes(dtype: torch.dtype) -> int:
    """``gemm::smem_bytes``: two stages of the A and B tiles, 128 rows of 32
    k padded to 40 bf16 or 36 f32."""
    return 2 * 2 * TILE * (40 * 2 if dtype == torch.bfloat16 else 36 * 4)


def split_k_rows(tiles: int, K: int) -> int:
    """``gemm::split_k_rows``: K rows a block of a product split over K
    takes, so that the blocks come near two a streaming multiprocessor, at
    least 8 chunks each."""
    chunks = -(-K // CHUNK)
    splits = max(1, min(2 * SM_COUNT // max(tiles, 1), -(-chunks // 8)))
    return -(-chunks // splits) * CHUNK
