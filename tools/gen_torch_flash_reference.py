"""Write the JAX package's flash outputs that the port's flash tests read.

Runs ``feos_tpu``'s ``flash`` and ``gc_flash`` on the fixed inputs of
``tests/test_flash.py`` (its six binary rows and its three gc rows, each at
five pressures: the log-midpoint of the two-phase window, log-blends 0.999
and 0.001 toward the bubble and the dew edge, 1.2 p_bubble and 0.8 p_dew)
and writes them, with the edge solutions, to
``tests/golden/torch_flash_jax.npz``.  Compiling JAX's flash takes minutes
on a CPU, longer than a test file may take, so the port's tests read this
file instead of calling JAX's flash.

With ``--jacobians`` it also stores JAX's ``gradients=True`` Jacobians on
the two-row system of ``tests/_flash_grad_checks.py`` at its mid-window
pressures: per row, d[beta, x1, x2, y1, y2, rho_L, rho_V] with respect to
[kij (2), parameters (2 x 8), p, T, x1] (``jax.jacfwd``).

Run from the repository root (the JAX package on its CPU backend):

    python tools/gen_torch_flash_reference.py [--jacobians]
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = ROOT / "tests" / "golden" / "torch_flash_jax.npz"
KINDS = ("mid", "bubble_edge", "dew_edge", "liquid", "vapor")


def pressures(p_bub, p_dew):
    """(5, B) pressures of ``KINDS`` from the edge pressures."""
    lb, ld = np.log(p_bub), np.log(p_dew)
    return np.stack([np.sqrt(p_bub * p_dew), np.exp(0.999 * lb + 0.001 * ld),
                     np.exp(0.001 * lb + 0.999 * ld), 1.2 * p_bub, 0.8 * p_dew])


def flash_outputs(fn, t, z1, p):
    """``fn(T, x1, p)`` on the (5, B) pressures tiled into one call, as a
    dict of (5, B, ...) arrays."""
    k, b = p.shape
    out = fn(np.tile(t, k), np.tile(z1, k), p.reshape(-1))
    names = ("beta", "x", "y", "rho", "phase")
    return {name: np.asarray(a).reshape((k, b) + np.shape(a)[1:])
            for name, a in zip(names, out)}


def mixture():
    import test_flash as tf
    from feos_tpu.models.pcsaft_mix import PcSaftMix

    eos = PcSaftMix(tf.PARAMS, tf.KIJ)
    p0 = np.full(len(tf.T), 1e5)
    p_bub, nb, y_bub = eos.bubble_point(tf.T, tf.Z1, p0, full_output=True)
    p_dew, nd, x_dew = eos.dew_point(tf.T, tf.Z1, p0, full_output=True)
    assert not np.any(np.asarray(nb)) and not np.any(np.asarray(nd))
    p_bub, p_dew = np.asarray(p_bub), np.asarray(p_dew)
    p = pressures(p_bub, p_dew)
    k = len(KINDS)
    big = PcSaftMix(np.tile(tf.PARAMS, (k, 1, 1)), np.tile(tf.KIJ, (k, 1)))
    out = flash_outputs(big.flash, tf.T, tf.Z1, p)
    rec = {"params": tf.PARAMS, "kij": tf.KIJ, "t": tf.T, "z1": tf.Z1, "p_bub": p_bub,
           "p_dew": p_dew, "y_bub": np.asarray(y_bub), "x_dew": np.asarray(x_dew), "p": p}
    rec.update(out)
    return {f"mix_{key}": v for key, v in rec.items()}


def gc_model(rows):
    import json

    from feos_tpu.models.gc_pcsaft import GcPcSaftMix

    segs = json.loads((ROOT / "tests" / "sauer2014_hetero.json").read_text())
    cols = ("m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb")
    parameter = tuple(np.array([r["model_record"].get(c, 0) for r in segs]) for c in cols)
    return GcPcSaftMix(
        [r["identifier"] for r in segs], parameter,
        [[["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]] * rows,
        [[[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]] * rows, [], None)


def gc():
    """tests/test_flash.py::test_gc_flash's system: butane/propane at 300 K."""
    t = np.full(3, 300.0)
    z1 = np.array([0.3, 0.5, 0.7])
    eos = gc_model(3)
    p0 = np.full(3, 5e5)
    p_bub, nb, y_bub = eos.bubble_point(t, z1, p0, full_output=True)
    p_dew, nd, x_dew = eos.dew_point(t, z1, p0, full_output=True)
    assert not np.any(np.asarray(nb)) and not np.any(np.asarray(nd))
    p_bub, p_dew = np.asarray(p_bub), np.asarray(p_dew)
    p = pressures(p_bub, p_dew)
    out = flash_outputs(gc_model(3 * len(KINDS)).flash, t, z1, p)
    rec = {"t": t, "z1": z1, "p_bub": p_bub, "p_dew": p_dew, "y_bub": np.asarray(y_bub),
           "x_dew": np.asarray(x_dew), "p": p}
    rec.update(out)
    return {f"gc_{key}": v for key, v in rec.items()}


def jacobians():
    """JAX's implicit-function Jacobians on _flash_grad_checks.py's rows."""
    import _flash_grad_checks as g
    from feos_tpu.models.pcsaft_mix import flash

    midp = g._midp()

    def outs(kij, params, p, t, z1):
        beta, x, y, rho, _ = flash(params, kij, t, z1, p, branches=g.BR, gradients=True)
        return jnp.concatenate([beta[:, None], x, y, rho], 1)

    args = tuple(jnp.asarray(a) for a in (g.KIJ, g.PARAMS, midp, g.T, g.Z1))
    values = np.asarray(outs(*args))
    jac = jax.jacfwd(outs, argnums=(0, 1, 2, 3, 4))(*args)
    rows = len(g.T)
    per_row = []
    for b in range(rows):
        cols = [np.asarray(jac[0])[b, :, b, :], np.asarray(jac[1])[b, :, b].reshape(7, -1),
                np.asarray(jac[2])[b, :, b, None], np.asarray(jac[3])[b, :, b, None],
                np.asarray(jac[4])[b, :, b, None]]
        per_row.append(np.concatenate(cols, 1))
    return {"grad_params": g.PARAMS, "grad_kij": g.KIJ, "grad_t": g.T, "grad_z1": g.Z1,
            "grad_p": midp, "grad_values": values, "grad_jacobian": np.stack(per_row)}


def main():
    t0 = time.perf_counter()
    rec = mixture()
    print(f"mixture flash: {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    rec.update(gc())
    print(f"gc flash: {time.perf_counter() - t1:.1f} s", flush=True)
    np.savez_compressed(OUT, **rec)
    print(f"wrote {OUT.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s", flush=True)
    if "--jacobians" in sys.argv[1:]:
        t2 = time.perf_counter()
        rec.update(jacobians())
        print(f"jacobians: {time.perf_counter() - t2:.1f} s", flush=True)
        np.savez_compressed(OUT, **rec)
        print(f"wrote {OUT.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
