"""mla_fwd_ms.ds: device milliseconds a training step of the operations
launched inside the latent attention's spans (``repro_torch.mla.*`` and
``repro_torch.attn.*``: the projections, the scores, softmax and values,
the output projection), mean over the traced run's profiled steps; the
forward pass only (the backward launches from autograd threads after the
spans close)."""


def read(rec):
    prof, fwd = rec.profile, rec.detail.get("fwd_ms")
    if not prof or not prof["busy_s"] or not fwd or "mla" not in fwd:
        return None
    return fwd["mla"]
