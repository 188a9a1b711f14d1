"""Share of its roofline, in percent, of phi_d2's kernels, which the
liquid density's NPT solve launches (h100bench/roofline.py::share)."""

from h100bench.roofline import share


def read(trace):
    return share(trace, "phi_d2", ("phi_d2_tile", "phi_d2_row", "phi_d2_elem"))
