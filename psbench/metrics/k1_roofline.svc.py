"""k1_roofline.svc: K1's byte bound over its measured device time, in %.
The bytes are the yardstick's (28 B per owned lane and 8 B per owned
block of the tick's block tables) at the card's data-sheet HBM rate; the
time is K1's mean launch in the profiled stretch."""

import importlib

K1 = "multijob_fused_kernel"


def read(rec):
    prof = rec.profile
    if not prof or not rec.owned_lanes:
        return None
    times = [s for name, s in prof["by_name"].items() if K1 in name]
    launches = sum(n for name, n in prof["launches"].items() if K1 in name)
    if not launches or not sum(times):
        return None
    yardstick = importlib.import_module("psbench.yardstick")
    bound = yardstick.k1_bound_s(rec.owned_lanes, rec.owned_blocks)
    return bound / (sum(times) / launches) * 100.0
