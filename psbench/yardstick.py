"""The benchmark's frozen arithmetic: the card's data-sheet peaks and the
byte and operation counts that rooflines and utilisations divide by.
Kept here, apart from the program, so a change to the program cannot
change the yardstick it is measured with."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit; a
# share against them is written beside the card's power.limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def k1_bytes(owned_lanes: int, owned_blocks: int) -> int:
    """Bytes the multi-job fused Adam kernel (K1) must move in one launch:
    per owned lane it reads p, mu, nu and the gradient and writes p, mu,
    nu (7 x 4 B); per owned block it reads its block id and job slot
    (2 x 4 B)."""
    return 28 * int(owned_lanes) + 8 * int(owned_blocks)


def k1_bound_s(owned_lanes: int, owned_blocks: int) -> float:
    """K1's least time on the card: its bytes over the HBM peak (its
    arithmetic, ~20 float32 operations a lane, is far below the
    float32 peak's share of that time)."""
    return k1_bytes(owned_lanes, owned_blocks) / HBM_BYTES_PER_S
