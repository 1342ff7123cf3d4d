"""Host ms per step inside the graphed call (utils/graphs.py) until it returns:
the inputs' copy-in and the replay's launch, averaged over the window's steps."""


def read(traced):
    ms = traced.timing.get("host_ms") or []
    return sum(ms) / len(ms) if ms else None
