"""push_ms.p95: the 95th percentile over every push of the window, from
its submit (host clock) to the synchronize that ends the tick that
applied it."""

import statistics


def read(rec):
    if len(rec.latencies) < 20:
        return None
    return statistics.quantiles(rec.latencies, n=100,
                                method="inclusive")[94] * 1e3
