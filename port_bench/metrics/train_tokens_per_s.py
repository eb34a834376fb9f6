"""Spliced tokens that are not padding, over the optimizer steps completed
in the window, over the time to the end of the last step (synchronized)."""


def read(rec):
    steps = rec.get("steps") or []
    if not steps:
        return None
    return sum(s["tokens"] for s in steps) / rec["window_s"]
