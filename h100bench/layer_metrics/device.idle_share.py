"""The share of the profiled window in which no operation ran on the card,
in percent: 1 - busy / window, busy the union of device activity."""


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
