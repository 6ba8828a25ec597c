"""moe_fwd_ms.ds: device milliseconds a training step of the operations
launched inside the MoE layers' spans (``repro_torch.moe.*``: the
router, the dispatch, the held experts, the shared experts, the
combine), mean over the traced run's profiled steps; the forward pass
only (the backward launches from autograd threads after the spans
close)."""


def read(rec):
    prof, fwd = rec.profile, rec.detail.get("fwd_ms")
    if not prof or not prof["busy_s"] or not fwd or "moe" not in fwd:
        return None
    return fwd["moe"]
