"""train_tokens_per_s: the tokens of every step of the window whose push
the service applied, over the window's seconds (host clock; the window
ends in the synchronize after its last tick)."""


def read(rec):
    if not rec.window_s or not rec.tokens:
        return None
    return rec.tokens / rec.window_s
