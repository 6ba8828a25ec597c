"""setup_s: process start to the first measured tick or step (loading,
registration, kernel builds or loads, warm-up), host clock."""


def read(rec):
    return rec.setup_s
