"""tick_ms.lm: milliseconds of ``engine.tick()`` after a training step,
from a synchronize before it to one after it, mean over the traced run's
``tick_steps`` steps after the window (the service's share of a step:
snapshot and K1)."""


def read(rec):
    if not rec.tick_s:
        return None
    return sum(rec.tick_s) / len(rec.tick_s) * 1e3
