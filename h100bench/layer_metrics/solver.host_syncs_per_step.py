"""Host waits on the device a step: CUDA runtime calls named
``*Synchronize`` in the profiled window (a device-to-host copy of a value
waits through one), the harness's own closing sync of each step among
them, over its steps."""


def read(trace):
    return trace.syncs / trace.steps if trace.device_ops else None
