"""Phi evaluations a row of the pure_vle kernel itself: the mean of the
per-row counts the kernel writes (``iters[:, 2]``) over the rows of its
newest launch in the profiled windows, as the port's tracer keeps it.  The
roofline shares count the reference's evaluations instead, the work the
rows need.  Nothing where no kernel ran (the CPU path) or where the program
has no tracer."""


def read(trace):
    try:
        from feos_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.profiled.phi_evals_per_row()
