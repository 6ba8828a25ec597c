"""tick_host_ms.svc: host milliseconds inside ``engine.tick()`` before the
synchronize, mean over the window's ticks (the tick engine's own host
path: tables, snapshots, queue pops and launches)."""


def read(rec):
    if not rec.tick_host_s:
        return None
    return sum(rec.tick_host_s) / len(rec.tick_host_s) * 1e3
