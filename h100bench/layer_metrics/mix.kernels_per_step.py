"""Device operations a step (kernels, copies and fills in the profiled
window, over its steps): the mixture path launches no kernel of its own, so
this counts its torch ops on the card."""


def read(trace):
    return trace.device_ops / trace.steps if trace.device_ops else None
