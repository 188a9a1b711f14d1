"""Share of its roofline, in percent, of the pure VLE solve's scan and
solve kernels (h100bench/roofline.py::share)."""

from h100bench.roofline import share


def read(trace):
    return share(trace, "pure_vle", ("pure_vle_scan", "pure_vle_solve"))
