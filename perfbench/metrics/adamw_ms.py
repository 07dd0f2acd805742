"""adamw_ms: device milliseconds a step of the kernels that run inside the
benchmark's ``optimizer`` span (``train/optimizer.py`` ``adamw_update``;
the span ends in a device synchronize, so its kernels run within it)."""


def read(t):
    spans = [(a, b) for a, b, n in t.spans if n == "optimizer"]
    if not spans or not t.steps:
        return None
    us = sum(k.end - k.start for k in t.kernels
             if any(a <= k.start <= b for a, b in spans))
    return us / 1e3 / t.steps
