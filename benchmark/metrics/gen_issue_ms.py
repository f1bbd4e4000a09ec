"""The host's own work to issue one generated batch, ms: the median host time inside a
sampler call (``_StaticSampler.__call__``, a graph replay each) over calls made after the
window, each with the device waited for before it."""


def read(r):
    return r.issue_ms()
