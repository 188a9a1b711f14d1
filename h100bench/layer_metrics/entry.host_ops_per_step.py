"""Aten ops the host dispatches a step (every ``aten::`` event of the
profiled window, nested ones included, over its steps)."""


def read(trace):
    return trace.host_ops / trace.steps if trace.host_ops else None
