"""Record the port's binary-mixture results, bit for bit, on fixed inputs.

Writes ``tests/golden/torch_binary_record.npz``: the inputs and outputs of
``feos_tpu_torch`` (on the CPU) for

* the derivative set (A, p~, mu, v) of the seeded binary states of
  ``tests/test_torch_mix_eos.py`` (every regime: none, dipolar, self, cross
  with and without an eps_AiBj override, induced), and the gradients of
  sum(p~ + mu + v) in the parameters and kij;
* bubble and dew pressures of config 3's pair and seeded cross-associating
  pairs (``tests/test_torch_mix_jax_bubble.py::cross_systems``), and of
  config 3's pair made induced (second component nA = 0) and
  self-associating (second component inert), with the incipient
  composition, the converged state, the mask and the gradients of sum ln p
  in the parameters and kij;
* gc bubble and dew pressures of the 11 golden topologies at 300 K, x1 =
  0.4, with the gradients of sum ln p in the segment parameters, k_ab and
  phi.

The file pins the binary paths of the association terms: a change that
should leave binaries alone (the n-component gather of the associating
pair) is held to it with ``assert_array_equal``.  Run from the root of the
tree whose results are to be recorded:

    python tools/record_torch_binary_reference.py
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

OUT = ROOT / "tests" / "golden" / "torch_binary_record.npz"
CONFIG3 = [[1, 3.5, 150, 0, 0.02, 1500, 1, 1], [1, 3.5, 200, 0, 0.03, 2500, 1, 1]]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def states():
    """The seeded states of tests/test_torch_mix_eos.py, rebuilt here so
    that the file holds its inputs."""
    from test_torch_mix_eos import _mix_states

    return _mix_states()


def derivative_set(params, kij, temperature, rho):
    from feos_tpu_torch.models import pcsaft_mix as mix

    p, k = _t(params).requires_grad_(), _t(kij).requires_grad_()
    a, pt, mu, v = mix.derivatives(p, k, _t(temperature), _t(rho))
    gp, gk = torch.autograd.grad(pt.sum() + mu.sum() + v.sum(), (p, k))
    return {"a": a, "p": pt, "mu": mu, "v": v, "grad_params": gp, "grad_kij": gk}


def binaries():
    """``(params, kij, T, x1)``: cross_systems(seed=21, n=4), then config
    3's pair made induced (at 150 and 160 K) and self-associating (at 140
    and 160 K)."""
    from test_torch_mix_jax_bubble import cross_systems

    params, kij, temperature, x1 = cross_systems(seed=21, n=4)
    induced = np.array(CONFIG3, dtype=float)
    induced[1, 6] = 0.0
    self_ = np.array(CONFIG3, dtype=float)
    self_[1, 4:] = 0.0
    extra = np.stack([induced, induced, self_, self_])
    return (np.concatenate([params, extra]),
            np.concatenate([kij, np.tile([-0.15, 0.0], (4, 1))]),
            np.concatenate([temperature, [150.0, 160.0, 140.0, 160.0]]),
            np.concatenate([x1, np.full(4, 0.5)]))


def incipient(fn, params, kij, temperature, x1):
    p_in, k_in = _t(params).requires_grad_(), _t(kij).requires_grad_()
    p, nans, y, state = fn(p_in, k_in, _t(temperature), _t(x1),
                           _t(np.full(len(x1), 1e5)), full_output=True, state_output=True)
    gp, gk = torch.autograd.grad(torch.log(torch.where(nans, 1.0, p)).sum(), (p_in, k_in))
    return {"p": p, "nans": nans, "y": y, "state": state, "grad_params": gp, "grad_kij": gk}


def gc_golden():
    import feos_tpu_torch as ft

    segs = json.loads((ROOT / "tests" / "sauer2014_hetero.json").read_text())
    cols = ("m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb")
    parameter = tuple(np.array([r["model_record"].get(c, 0.0) for r in segs]) for c in cols)
    gold = json.loads((ROOT / "tests" / "golden" / "gc_helmholtz.json").read_text())
    eos = ft.GcPcSaftMix([r["identifier"] for r in segs], parameter, gold["segment_lists"],
                         gold["bond_lists"], [tuple(k) for k in gold["kab_list"]],
                         np.array(gold["phi"]), device="cpu")
    n = len(gold["labels"])
    out = {}
    for name in ("bubble", "dew"):
        eos.zero_grad(set_to_none=True)
        fn = eos.bubble_point if name == "bubble" else eos.dew_point
        p, nans, y, state = fn(_t(np.full(n, 300.0)), _t(np.full(n, 0.4)),
                               _t(np.full(n, 1e5)), full_output=True, state_output=True)
        torch.log(torch.where(nans, 1.0, p)).sum().backward()
        out.update({f"gc_{name}_{k}": v for k, v in {
            "p": p, "nans": nans, "y": y, "state": state, "grad_parameter": eos.parameter.grad,
            "grad_kab": eos.kab.grad, "grad_phi": eos.phi.grad}.items()})
    return out


def main():
    import feos_tpu_torch as ft

    rec = {}
    params, kij, temperature, rho = states()
    rec.update({"eos_params": params, "eos_kij": kij, "eos_t": temperature, "eos_rho": rho})
    eos = derivative_set(params, kij, temperature, rho)
    rec.update({f"eos_{k}": v for k, v in eos.items()})
    params, kij, temperature, x1 = binaries()
    rec.update({"vle_params": params, "vle_kij": kij, "vle_t": temperature, "vle_x1": x1})
    for name, fn in (("bubble", ft.bubble_point), ("dew", ft.dew_point)):
        rec.update({f"{name}_{k}": v
                    for k, v in incipient(fn, params, kij, temperature, x1).items()})
    rec.update(gc_golden())
    rec = {k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
           for k, v in rec.items()}
    np.savez_compressed(OUT, **rec)
    print(f"wrote {OUT.relative_to(ROOT)}: {len(rec)} arrays")


if __name__ == "__main__":
    main()
