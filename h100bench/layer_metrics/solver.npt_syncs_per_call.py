"""Host syncs of one ``npt_density`` call: its loop's stop tests (one an
iteration and the last), ``sync.npt_density`` over ``calls.solver.npt_density``
of the port's tracer in the profiled windows.  Nothing where the program has
no tracer or made no such call."""


def read(trace):
    try:
        from feos_tpu_torch import tracing
    except ImportError:
        return None
    counters = tracing.profiled.counters
    calls = counters.get("calls.solver.npt_density", 0)
    return counters.get("sync.npt_density", 0) / calls if calls else None
