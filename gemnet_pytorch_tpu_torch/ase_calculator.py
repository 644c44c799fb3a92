"""The reference's root-level module layout (reference ase_calculator.py),
as the repository's `ase_calculator.py` gives it for the JAX package: the
molecule container, the calculator and the MD simulator of this package.
`make_ase_calculator` imports ASE only when it is called."""

from .data.containers import Molecule  # noqa: F401
from .md import GemNetCalculator, MDSimulator, make_ase_calculator  # noqa: F401
