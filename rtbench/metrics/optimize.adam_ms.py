"""adam_update's time per fit step (grad/optimize.py): the host clock around the
call with the card synchronised before and after, averaged over the window's steps
after the profiled stretch (the profiled steps synchronise nothing, so that the
device's idle share reads the loop as it runs untraced)."""


def read(traced):
    ms = traced.timing.get("adam_ms") or []
    return sum(ms) / len(ms) if ms else None
