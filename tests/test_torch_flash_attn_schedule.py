"""The bfloat16 flash attention kernel's walk over key tiles
(``repro_torch.kernels.flash_attn.ops.tile_schedule``, the formulas of
``flash_fwd_wgmma``) held against the plain version's mask, and the
kernel route's refusal of head widths it was not compiled for.

The mask is read off ``flash_attention_plain`` itself: with q and k all
zero every visible key gets the same weight, and with v the identity
(D = S_k) output column j of row i is non-zero exactly when key j is
visible to query i.  For each query tile the schedule says which key
tiles the kernel visits (n_tiles) and which of them it runs without a
mask (n_unmasked).  It is right when every visible (query, key) pair
lies in a visited tile, every unmasked tile is visible whole to every
row of the query tile, and no skipped tile holds a visible pair.  The
cases cover the kernel's query tiles (128 and 192 rows), key tiles of
64, 128 and 176, causal or not, S_q = S_k and S_q < S_k (the bottom-right
offset), aligned and ragged.
"""

import functools

import pytest
import torch

from repro_torch.kernels.flash_attn import ops, ref

SHAPES = [  # (S_q, S_k)
    (384, 384),    # every tile whole at BQ 128 / 192, BK 64 / 128
    (1000, 1000),  # ragged queries and keys
    (300, 1000),   # S_q < S_k, ragged
    (256, 1024),   # S_q < S_k, aligned
]


@functools.lru_cache(maxsize=None)
def _plain_mask(sq: int, sk: int, causal: bool) -> torch.Tensor:
    q = torch.zeros(1, sq, 1, sk)
    k = torch.zeros(1, sk, 1, sk)
    v = torch.eye(sk)[None, :, None, :]
    out = ref.flash_attention_plain(q, k, v, causal=causal)
    return out[0, :, 0, :] > 0  # (S_q, S_k): key j visible to query i


@pytest.mark.parametrize("sq,sk", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bk", [64, 128, 176])
@pytest.mark.parametrize("bq", [128, 192])
def test_tile_schedule_covers_the_plain_mask(bq, bk, causal, sq, sk):
    mask = _plain_mask(sq, sk, causal)
    sched = ops.tile_schedule(sq, sk, bq, bk, causal)
    assert len(sched) == -(-sq // bq)
    for qt, (n_tiles, n_unmasked) in enumerate(sched):
        rows = mask[qt * bq:(qt + 1) * bq]
        assert 0 <= n_unmasked <= n_tiles <= -(-sk // bk)
        # every visible pair lies in a visited tile; no skipped tile
        # holds one
        assert not rows[:, n_tiles * bk:].any()
        # the unmasked tiles are visible whole, to every row
        assert rows[:, :n_unmasked * bk].all()
        # and the schedule masks no more than it must: the first masked
        # tile is not visible whole (its last key is hidden from a row or
        # lies past S_k)
        if n_unmasked < n_tiles:
            first = rows[:, n_unmasked * bk:(n_unmasked + 1) * bk]
            assert first.shape[1] < bk or not first.all()


def test_tile_schedule_at_the_prefill_shape():
    """The prefill's layer (S 32 768, causal) at the D = 64 tiles: the
    last query tile visits every key tile and masks the two it crosses."""
    bq, bk = ops.BF16_TILES[64]
    sched = ops.tile_schedule(32768, 32768, bq, bk, True)
    assert len(sched) == 171
    assert sched[-1] == (256, 255)
    assert sched[0] == (2, 0)
    masked = sum(n - u for n, u in sched)
    assert masked <= 2 * len(sched)


@pytest.mark.parametrize("d", [16, 32])
def test_kernel_route_refuses_bf16_head_dims_not_compiled(d):
    q = torch.zeros(1, 8, 2, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head dim .* \(have \(64, 128\)\)"):
        ops._check_kernel(q, q, q)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 16),
                                     (torch.float32, 32)])
def test_kernel_route_takes_compiled_head_dims(dtype, d):
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    ops._check_kernel(q, q, q)
    # on the CPU the wrapper runs the plain version at any width
    assert ops.flash_attention(q, q, q).shape == q.shape
