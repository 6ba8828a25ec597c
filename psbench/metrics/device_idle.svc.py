"""device_idle.svc: the share of the profiled stretch of service ticks in
which no operation ran on the device, in %."""


def read(rec):
    prof = rec.profile
    if not prof or not prof["window_s"] or not prof["busy_s"]:
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0
