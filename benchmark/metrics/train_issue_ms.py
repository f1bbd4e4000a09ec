"""The host's own work to issue one D+G step, ms: the median host time inside a step call
(``StaticStep.__call__``, a graph replay each) over calls made after the window, each with
the device waited for before it, so that none of it is a wait for a free launch slot."""


def read(r):
    return r.issue_ms()
