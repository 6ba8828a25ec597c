"""agg_mparams_per_s: payload parameters of every push applied in the
window, over the window's seconds (host clock; the window ends in the
synchronize of its last tick)."""


def read(rec):
    if not rec.window_s or not rec.applied_params:
        return None
    return rec.applied_params / rec.window_s / 1e6
