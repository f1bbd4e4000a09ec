"""The device's idle share of the traced generation window, percent: 100 (1 - busy /
window)."""


def read(r):
    return r.idle_pct()
