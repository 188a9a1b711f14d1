"""Write the JAX package's n-component values that the port's ternary tests
read.

Runs ``feos_tpu`` on the ternaries of ``tests/test_torch_multicomponent.py``
(seeded inputs made with numpy) and writes ``tests/golden/
torch_multicomponent_jax.npz``:

* ``mix_*``: ``bubble_point`` and ``dew_point`` with ``full_output`` and
  ``state_output`` on the non-associating and the cross-associating
  ternary (the latter in JAX's slot order [A, B, inert]);
* ``gc_*``: the same through ``gc_incipient_property`` on butane/propane/
  pentane and on the gc cross-associating ternary;
* ``t_*``: ``bubble_point_t`` on the non-associating rows at JAX's own
  bubble pressures, from 1.05 T;
* ``flash_*``: ``flash`` on two non-associating rows at the log-midpoint of
  JAX's bubble and dew pressures;
* ``props_*``: ``mix_properties`` at the liquid and the vapor of the first
  cross-associating bubble point;
* ``jac_*``: at the densities JAX converged to, the stationary bubble/dew
  identity built from JAX's f64 ``precompute_mix``/``phi_mix_pre``/
  ``pressure_set`` and its ``jax.jacfwd`` in the (3, 8) parameters, in Pa,
  per row and direction.

Compiling these on a CPU takes minutes (every solve, then the flash, then
the Jacobians), so the tests read this file.  Run from the repository root
(the JAX package on its CPU backend):

    python tools/gen_torch_multicomponent_reference.py
"""

import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_multicomponent as tm  # noqa: E402

OUT = ROOT / "tests" / "golden" / "torch_multicomponent_jax.npz"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def mixture():
    from feos_tpu.models import pcsaft_mix as jmix

    params, temperature, z = tm.ternaries()
    p0 = np.full(len(temperature), 1e5)
    br = jmix.static_branches(params)
    rec = {"mix_params": params, "mix_t": temperature, "mix_z": z}
    for name, fn in (("bubble", jmix.bubble_point), ("dew", jmix.dew_point)):
        t0 = time.perf_counter()
        out = jax.jit(partial(fn, branches=br, full_output=True, state_output=True))(
            params, None, temperature, z, p0)
        for key, x in zip(("p", "nans", "comp", "state"), _np(out)):
            rec[f"mix_{name}_{key}"] = x
        print(f"mixture {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return rec


def gc():
    from feos_tpu.models.gc_pcsaft import (
        GcPcSaftMix, gc_incipient_property, static_branches_gc,
    )

    molecules, temperature, z = tm.gc_ternaries()
    ident, parameter = tm.sauer2014()
    segments, bonds = tm.gc_lists(molecules)
    params = GcPcSaftMix(ident, parameter, segments, bonds, tm.GC_KAB, None).params
    br = static_branches_gc(params)
    p0 = np.full(len(temperature), 1e5)
    rec = {"gc_t": temperature, "gc_z": z}
    for name in ("bubble", "dew"):
        t0 = time.perf_counter()
        fn = partial(gc_incipient_property, bubble=name == "bubble", branches=br,
                     full_output=True, state_output=True)
        out = jax.jit(fn)(params, temperature, z, p0)
        for key, x in zip(("p", "nans", "comp", "state"), _np(out)):
            rec[f"gc_{name}_{key}"] = x
        print(f"gc {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return rec


def temperatures(rec):
    from feos_tpu.models import pcsaft_mix as jmix

    n = tm.ROWS
    params, z = rec["mix_params"][:n], rec["mix_z"][:n]
    t, p = rec["mix_t"][:n], rec["mix_bubble_p"][:n]
    t0 = time.perf_counter()
    out = jax.jit(partial(jmix.bubble_point_t, branches=jmix.static_branches(params),
                          full_output=True))(params, None, p, z, 1.05 * t)
    print(f"bubble_point_t: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(zip(("t_t", "t_nans", "t_comp"), _np(out)))


def flash(rec):
    from feos_tpu.models import pcsaft_mix as jmix

    rows = list(tm.FLASH_ROWS)
    params, z, t = rec["mix_params"][rows], rec["mix_z"][rows], rec["mix_t"][rows]
    p = np.sqrt(rec["mix_bubble_p"][rows] * rec["mix_dew_p"][rows])
    t0 = time.perf_counter()
    out = jax.jit(partial(jmix.flash, branches=jmix.static_branches(params)))(
        params, None, t, z, p)
    print(f"flash: {time.perf_counter() - t0:.1f} s", flush=True)
    rec = {"flash_p": p}
    rec.update({f"flash_{k}": x for k, x in zip(("beta", "x", "y", "rho", "phase"), _np(out))})
    return rec


def properties(rec):
    from feos_tpu.properties import mix_properties

    i = tm.ROWS  # the first cross-associating row
    state = rec["mix_bubble_state"][i]
    n = state.shape[0] - 1
    rho = np.stack([rec["mix_z"][i] * np.exp(state[n]), np.exp(state[:n])])
    t0 = time.perf_counter()
    out = mix_properties(np.stack([rec["mix_params"][i]] * 2), None,
                         np.full(2, rec["mix_t"][i]), rho)
    print(f"mix_properties: {time.perf_counter() - t0:.1f} s", flush=True)
    got = {"props_rho": rho}
    got.update({f"props_{f}": np.asarray(getattr(out, f)) for f in out._fields})
    return got


def identity(p, t, r_inc, r_bulk):
    """The stationary bubble/dew identity p~ at (r_inc, r_bulk), one row."""
    from feos_tpu.models import pcsaft_mix as jmix
    from feos_tpu.ops.derivatives import pressure_set

    zero = jnp.zeros((), dtype=jnp.float64)
    pre = jmix.precompute_mix(jmix.MixParams.from_array(p), zero, zero, t)

    def phi(x):
        return jmix.phi_mix_pre(pre, x, branches=frozenset({"cross"}))

    _, p_b, g_b, v_b = pressure_set(phi, r_bulk)
    mu_b = jnp.log(r_bulk) + g_b
    rho_t = r_inc.sum()
    w = r_inc / rho_t
    v_bulk = (w * v_b).sum()
    g_bulk = (w * (jnp.log(r_inc) - mu_b)).sum()
    return -(phi(r_inc) / rho_t + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_t - v_bulk)


def jacobians(rec):
    from feos_tpu.units import REDUCED_TO_PA_PER_KT

    params, t, z = rec["mix_params"], rec["mix_t"], rec["mix_z"]
    n = params.shape[1]
    args = []
    for name in ("bubble", "dew"):
        state = rec[f"mix_{name}_state"]
        args.append((params, t, np.exp(state[:, :n]), z * np.exp(state[:, n:])))
    args = [np.concatenate(a) for a in zip(*args)]

    def with_value(*a):
        out = identity(*a)
        return out, out

    t0 = time.perf_counter()
    jac, val = _np(jax.jit(jax.vmap(jax.jacfwd(with_value, has_aux=True)))(*args))
    print(f"jacobians: {time.perf_counter() - t0:.1f} s", flush=True)
    scale = np.tile(t, 2) * REDUCED_TO_PA_PER_KT
    B = len(t)
    out = {}
    for i, name in enumerate(("bubble", "dew")):
        sl = slice(i * B, (i + 1) * B)
        out[f"jac_{name}_ident"] = val[sl] * scale[sl]
        out[f"jac_{name}_params"] = jac[sl] * scale[sl, None, None]
    return out


def main():
    t0 = time.perf_counter()
    rec = mixture()
    rec.update(gc())
    rec.update(temperatures(rec))
    rec.update(properties(rec))
    rec.update(jacobians(rec))
    np.savez_compressed(OUT, **rec)
    print(f"wrote {OUT.relative_to(ROOT)} without the flash in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rec.update(flash(rec))
    np.savez_compressed(OUT, **rec)
    print(f"wrote {OUT.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
