"""Share of its roofline, in percent, of the vapor-pressure identity's
kernel (h100bench/roofline.py::share)."""

from h100bench.roofline import share


def read(trace):
    return share(trace, "vp_identity", ("vp_identity_kernel",))
