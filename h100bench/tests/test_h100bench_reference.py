"""The frozen reference agrees with the port's CPU path on masks, values
and gradients, on a few hundred rows of the cells' distributions."""

import json

import pytest
import torch

import feos_tpu_torch as ftt
from h100bench.common import pure_rows
from h100bench.harness import HERE
from h100bench.reference import solve as ref

DIST = json.loads((HERE / "configs" / "pcsaft_pure_regression.json").read_text())["distribution"]
BINARY = json.loads((HERE / "configs" / "pcsaft_binary_kij.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rows():
    return pure_rows(300, 2**31 + 77, CPU, DIST)


def _scaled(g, want):
    scale = want.abs().amax(-1, keepdim=True)
    return float(((g - want).abs() / torch.where(scale > 0, scale, 1.0)).max())


def test_vapor_pressure(rows):
    params, temperature = rows
    p_ref, ok_ref, g_ref = ref.vapor_pressure(params, temperature)
    q = params.clone().requires_grad_()
    nans, p = ftt.vapor_pressure(q, temperature)
    torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, p))).sum().backward()
    assert torch.equal(~nans, ok_ref) and bool(ok_ref.all())
    assert float(((p.detach() - p_ref) / p_ref).abs().max()) < 1e-12
    assert _scaled(q.grad, g_ref) < 1e-11


def test_liquid_density(rows):
    params, temperature = rows
    p_ref, _, _ = ref.vapor_pressure(params, temperature)
    theta = (params * 1.01).contiguous()
    rho_ref, ok_ref, g_ref = ref.liquid_density(theta, temperature, p_ref)
    q = theta.clone().requires_grad_()
    nans, rho = ftt.liquid_density(q, temperature, p_ref)
    rho.sum().backward()
    assert torch.equal(~nans, ok_ref) and bool(ok_ref.all())
    assert float(((rho.detach() - rho_ref) / rho_ref).abs().max()) < 1e-12
    assert _scaled(q.grad, g_ref) < 1e-9


@pytest.mark.parametrize("theta", [(-0.15, 1000.0), (0.01, 880.0)], ids=["data", "walk"])
def test_bubble_point(theta):
    B = 24
    comps = torch.tensor(BINARY["components"], dtype=torch.float64).expand(B, 2, 8)
    temperature = torch.linspace(*BINARY["temperature_k"], B, dtype=torch.float64)
    x1 = torch.full((B,), BINARY["x1"], dtype=torch.float64)
    x = torch.stack([x1, 1.0 - x1], -1)
    kij = torch.full((B,), theta[0], dtype=torch.float64)
    eps = torch.full((B,), theta[1], dtype=torch.float64)
    p_ref, ok_ref, u = ref.bubble_point(comps.contiguous(), kij, eps, temperature, x)
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    pa = ref.bubble_pressure_attached(comps.contiguous(), t[0].expand(B), t[1].expand(B),
                                      temperature, x, u)
    (g_ref,) = torch.autograd.grad(pa.sum(), t)
    s = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    p, nans = ftt.bubble_point(comps, s.expand(B, 2), temperature, x1, p_ref)
    p.sum().backward()
    assert torch.equal(~nans, ok_ref) and bool(ok_ref.all())
    assert float(((p.detach() - p_ref) / p_ref).abs().max()) < 1e-12
    assert float(((pa.detach() - p_ref) / p_ref).abs().max()) < 1e-12
    assert float(((s.grad - g_ref).abs() / g_ref.abs().max()).max()) < 1e-10
