"""Unit conversion constants (fp64 scalars).

The reference uses the ``si-units`` package to assemble dimensionless
conversion factors at call sites (e.g. ``PASCAL/(KB*KELVIN)*ANGSTROM**3`` at
reference ``feos_torch/pcsaft_pure.py:196``).  On TPU we avoid a unit-type
system entirely: every factor the reference ever builds is pre-collapsed here
into a plain float, in the same internal "reduced" unit system:

* temperatures in Kelvin,
* number densities in molecules per cubic Angstrom (A^-3),
* reduced Helmholtz energy density  phi = A / (kB * T * V) in A^-3,
* reduced pressure  p~ = p * A^3 / (kB * T)  in A^-3.

CODATA 2018 exact values (matching the Rust `si-units`/`feos` crates).
"""

# Fundamental constants (SI)
KB = 1.380649e-23  # Boltzmann constant, J/K
NAV = 6.02214076e23  # Avogadro constant, 1/mol
ANGSTROM = 1e-10  # m
RGAS = KB * NAV  # J/(mol K)

# Pa / (kB * K) * A^3  ->  converts p[Pa]/T[K] into reduced pressure (A^-3).
# Reference: feos_torch/pcsaft_pure.py:196.
PA_PER_KT_TO_REDUCED = ANGSTROM**3 / KB  # = 7.2429716...e-8

# kB * K / A^3 / Pa  ->  converts reduced pressure * T[K] into Pa.
# Reference: feos_torch/pcsaft_pure.py:215.
REDUCED_TO_PA_PER_KT = KB / ANGSTROM**3  # = 1.380649e7

# (kmol/m^3) expressed in molecules/A^3: (KILO*MOL/METER**3)*(NAV*ANGSTROM**3).
# Reference: feos_torch/pcsaft_pure.py:199.
KMOL_M3_TO_REDUCED = 1e3 * NAV * ANGSTROM**3  # = 6.02214076e-4

# Dipole reduction factor: 1e-19 * (JOULE/KELVIN/KB); multiplies
# mu[Debye]^2 / (m sigma^3 epsilon_k)  (reference feos_torch/pcsaft_pure.py:94-99).
MU2_FACTOR = 1e-19 / KB  # = 7242.97166...
