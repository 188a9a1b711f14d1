"""Write the JAX package's binary bubble/dew values and Jacobians that the
port's tests read.

Writes ``tests/golden/torch_mix_jax.npz`` with

* ``bubble_*``/``dew_*``: the inputs ``cross_systems(seed=21/22, n=4)`` of
  ``tests/test_torch_mix_jax_bubble.py`` and JAX's ``bubble_point``/
  ``dew_point`` outputs with ``full_output`` (p, nans, composition);
* ``grad_*``: the inputs ``cross_systems(seed=24, n=4)``, the port's
  converged densities of each direction on them (on the CPU), and at those
  densities the stationary bubble/dew identity built from JAX's f64
  ``precompute_mix``/``phi_mix_pre``/``pressure_set``, with its ``jacfwd``
  in the parameters and kij, in Pa; and ``jacfwd`` of JAX's derivative set
  on the cross-associating states of ``tests/test_torch_mix_eos.py``.

Compiling these on a CPU takes minutes, longer than a test file may take,
so ``test_torch_mix_jax_bubble.py``, ``test_torch_mix_jax_dew.py`` and
``test_torch_mix_jax_grad.py`` read this file.  Run from the repository
root (the JAX package on its CPU backend; about 3 min):

    python tools/gen_torch_mix_jax_reference.py
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = ROOT / "tests" / "golden" / "torch_mix_jax.npz"


def incipient(name, seed):
    """JAX's bubble or dew point on cross_systems(seed, n=4)."""
    from feos_tpu.models import pcsaft_mix as jmix
    from test_torch_mix_jax_bubble import cross_systems

    params, kij, temperature, x1 = cross_systems(seed=seed, n=4)
    p0 = np.full(len(x1), 1e5)
    br = jmix.static_branches(params)
    fn = jmix.bubble_point if name == "bubble" else jmix.dew_point
    p, nans, comp = jax.jit(lambda *a: fn(*a, branches=br, full_output=True))(
        params, kij, temperature, x1, p0)
    return {f"{name}_params": params, f"{name}_kij": kij, f"{name}_t": temperature,
            f"{name}_x1": x1, f"{name}_p": np.asarray(p), f"{name}_nans": np.asarray(nans),
            f"{name}_comp": np.asarray(comp)}


def identity_and_set(p, k, t, r_inc, r_bulk):
    """``[identity p~, A, p~, mu_0, mu_1, v_0, v_1]``: the bubble/dew
    identity at (r_inc, r_bulk) and the derivative set at r_bulk, per row."""
    from feos_tpu.models import pcsaft_mix as jmix
    from feos_tpu.ops.derivatives import pressure_set as jpressure_set

    pre = jmix.precompute_mix(jmix.MixParams.from_array(p), k[0], k[1], t)

    def phi(x):
        return jmix.phi_mix_pre(pre, x, branches=frozenset({"cross"}))

    a, p_b, g_b, v_b = jpressure_set(phi, r_bulk)
    mu_b = jnp.log(r_bulk) + g_b
    rho_t = r_inc.sum()
    w = r_inc / rho_t
    v_bulk = (w * v_b).sum()
    g_bulk = (w * (jnp.log(r_inc) - mu_b)).sum()
    ident = -(phi(r_inc) / rho_t + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_t - v_bulk)
    return jnp.concatenate([ident[None], a[None], p_b[None], g_b, v_b])


def gradients():
    """The identity's value and Jacobians at the port's densities, and the
    derivative set's Jacobians on the cross-associating states."""
    from feos_tpu.units import REDUCED_TO_PA_PER_KT
    from test_torch_mix_eos import _mix_states, regime_rows
    from test_torch_mix_jax_bubble import cross_systems
    from test_torch_mix_jax_grad import BUBBLE, _port_point

    params, kij, temperature, x1 = cross_systems(seed=24, n=4)
    rec = {"grad_params": params, "grad_kij": kij, "grad_t": temperature, "grad_x1": x1}
    rows = []
    for name in BUBBLE:
        *_, rho_inc, rho_bulk = _port_point(name, params, kij, temperature, x1)
        rec[f"grad_{name}_rho_inc"], rec[f"grad_{name}_rho_bulk"] = rho_inc, rho_bulk
        rows.append((params, kij, temperature, rho_inc, rho_bulk))
    s_params, s_kij, s_temperature, s_rho = (
        x[regime_rows("cross", "cross_eps")] for x in _mix_states())
    rows.append((s_params, s_kij, s_temperature, 0.5 * s_rho, s_rho))
    args = [np.concatenate(a) for a in zip(*rows)]

    def with_value(*a):
        out = identity_and_set(*a)
        return out, out

    ref = jax.jit(jax.vmap(jax.jacfwd(with_value, argnums=(0, 1), has_aux=True)))
    (j_par, j_kij), val = jax.tree_util.tree_map(np.asarray, ref(*args))
    B = len(x1)
    scale = (temperature * REDUCED_TO_PA_PER_KT)[:, None, None]
    for i, name in enumerate(BUBBLE):
        sl = slice(i * B, (i + 1) * B)
        rec[f"grad_{name}_ident"] = val[sl, 0] * scale[:, 0, 0]
        rec[f"grad_{name}_jpar"] = j_par[sl, 0] * scale
        rec[f"grad_{name}_jkij"] = j_kij[sl, 0] * scale[:, 0]
    rec["grad_eos_jpar"], rec["grad_eos_jkij"] = j_par[2 * B:, 1:], j_kij[2 * B:, 1:]
    return rec


def main():
    t0 = time.perf_counter()
    rec = {}
    for name, seed in (("bubble", 21), ("dew", 22)):
        t1 = time.perf_counter()
        rec.update(incipient(name, seed))
        print(f"{name}_point: {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    rec.update(gradients())
    print(f"jacobians: {time.perf_counter() - t1:.1f} s", flush=True)
    np.savez_compressed(OUT, **rec)
    print(f"wrote {OUT.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
