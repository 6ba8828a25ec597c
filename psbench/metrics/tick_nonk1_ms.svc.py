"""tick_nonk1_ms.svc: device milliseconds a tick spends outside K1 (the
multi-job fused Adam kernel): gradient concatenation, snapshots, the
error-feedback rounds, copies; from the profiled stretch."""

K1 = "multijob_fused_kernel"


def read(rec):
    prof = rec.profile
    if not prof or not rec.profile_ticks or not prof["by_name"]:
        return None
    other = sum(s for name, s in prof["by_name"].items() if K1 not in name)
    return other / rec.profile_ticks * 1e3
