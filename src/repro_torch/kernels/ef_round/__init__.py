"""Error-feedback round of a compressed push: one pass over the piece."""
