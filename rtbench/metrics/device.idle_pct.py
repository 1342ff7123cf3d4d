"""The share of the profiled stretch's wall time in which no kernel or copy ran, in %."""


def read(traced):
    if not traced.dev or traced.window_us() <= 0:
        return None
    return 100.0 * (1.0 - traced.busy_us() / traced.window_us())
