"""The port's ``fit_gc`` recovers a k_ab from bubble pressures.

The system of ``tests/test_regression.py::test_fit_gc_recovers_kab`` (two
single-segment molecules, 8 rows): bubble pressures generated by the port
at k_ab = -0.1, checked against the C++ oracle, must be recovered from a
k_ab = 0 start at that test's bars, through the gc parameter assembly and
the stationary bubble-point identity, with the solver's state carried from
step to step.  No JAX function is compiled here.
"""

import numpy as np
import torch

from _torch_oracle import backend  # noqa: F401 (a fixture)
import feos_tpu_torch as ft

IDENT = ["A", "B"]
PARAMETER = (np.array([1.0, 1.0]), np.array([3.5, 3.5]), np.array([150.0, 200.0]),
             np.zeros(2), np.zeros(2), np.zeros(2), np.zeros(2), np.zeros(2))
KAB_TRUE = -0.1
B = 8
T = np.linspace(140.0, 160.0, B)
X1 = np.linspace(0.2, 0.8, B)
SEGMENTS = [[["A"], ["B"]]]
BONDS = [[[], []]]


def test_fit_gc_recovers_kab(backend):  # noqa: F811
    eos = ft.GcPcSaftMix(IDENT, PARAMETER, SEGMENTS * B, BONDS * B, [("A", "B", KAB_TRUE)],
                         None, device="cpu")
    with torch.no_grad():
        p_data, nans = eos.bubble_point(T, X1, np.full(B, 1e5))
    assert not nans.any()
    _, p_oracle, ok = backend.gc_vle_densities(eos.params.detach(), T, X1, np.full(B, 1e5),
                                               True)
    assert ok.all()
    np.testing.assert_allclose(p_data.numpy(), p_oracle, rtol=1e-9)

    res = ft.fit_gc(IDENT, PARAMETER, SEGMENTS, BONDS, [("A", "B", 0.0)], T, X1,
                    p_data.numpy(), steps=80, device="cpu")
    losses = res.loss_history.numpy()
    assert abs(float(res.parameters[0]) - KAB_TRUE) < 5e-3
    assert losses[-1] < 1e-5
    assert losses[-1] < 1e-4 * losses[0]


def test_fit_gc_tiles_one_system_and_accepts_per_row_phi():
    """One system tiled over the rows equals the same system listed per
    row, with phi given once or per row."""
    data = np.full(B, 1e5)
    runs = [ft.fit_gc(IDENT, PARAMETER, SEGMENTS, BONDS, [("A", "B", 0.0)], T, X1, data,
                      phi=[1.0, 1.02], steps=2, device="cpu"),
            ft.fit_gc(IDENT, PARAMETER, SEGMENTS * B, BONDS * B, [("A", "B", 0.0)], T, X1,
                      data, phi=np.tile([1.0, 1.02], (B, 1)), steps=2, device="cpu")]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
