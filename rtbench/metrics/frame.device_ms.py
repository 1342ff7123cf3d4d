"""Device ms per step (core/render.py, core/shading.py, autograd): the union of the
kernel and copy intervals over the profiled steps, per step."""


def read(traced):
    if not traced.steps or not traced.dev:
        return None
    return traced.busy_us() * 1e-3 / len(traced.steps)
