"""Device busy ms per D+G step: the union of the device's activity in the traced window
over the steps it completed."""


def read(r):
    return r.device_ms()
