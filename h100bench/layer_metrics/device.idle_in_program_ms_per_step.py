"""Idle device time a step, in ms, while the host ran the port's own Python
between torch ops: the idle gaps of the host-and-device window that the
harness puts down to one of the port's ``feos.`` spans (the innermost host
event running at the gap's midpoint), over the window's steps.  Nothing
without device activity or where the program has no tracer."""


def read(trace):
    try:
        from feos_tpu_torch import tracing
    except ImportError:
        return None
    if not trace.device_ops:
        return None
    ns = sum(t for name, t in trace.idle_by_host.items() if name.startswith(tracing.PREFIX))
    return ns * 1e-6 / trace.steps
