"""Host syncs a step made by the port's own solver and model code: the sum
of the tracer's ``sync.*`` counters over its ``calls.entry.vapor_pressure``
in the profiled windows.  Each cell's step calls ``vapor_pressure`` once, so
that is the number of steps.  The harness's closing sync of each step is not
among them (``solver.host_syncs_per_step`` counts it).  Nothing where the
program has no tracer."""


def read(trace):
    try:
        from feos_tpu_torch import tracing
    except ImportError:
        return None
    counters = tracing.profiled.counters
    steps = counters.get("calls.entry.vapor_pressure", 0)
    if not steps:
        return None
    return sum(n for name, n in counters.items() if name.startswith("sync.")) / steps
