"""Process start to the first timed operation (weights, kernel builds on a
first run, warm-up)."""


def read(rec):
    return rec.get("setup_s")
