"""register_s: the seconds of set-up spent registering the jobs with
the service (each ``add_job``, ended by a synchronize), summed."""


def read(rec):
    spans = rec.spans.seconds.get("register")
    return sum(spans) if spans else None
