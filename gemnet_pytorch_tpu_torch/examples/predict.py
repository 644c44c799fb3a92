"""Inference example: the counterpart of `examples/predict.py` (the
reference's predict.ipynb).

    python -m gemnet_pytorch_tpu_torch.examples.predict DIR [--device cpu]

Loads the configuration and scaling factors of the pretrained directory DIR
(model_kwargs.json, scaling_factors.json beside it or in its parent) and
predicts the energy and forces of a benzonitrile molecule through
`md.GemNetCalculator` (the captured predict on the card). Without released
weights in DIR the weights are random, drawn from seed 0.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data import Molecule
from ..md import GemNetCalculator
from ..pretrained import load_pretrained

# benzonitrile-like C7NH5 geometry (the reference demo's molecule)
Z = np.array([6, 6, 6, 6, 6, 6, 6, 7, 1, 1, 1, 1, 1])
R = np.array([
    [-1.2131, -0.6884, 0.0], [-1.2028, 0.7064, 0.0001],
    [-0.0103, 1.4246, 0.0001], [1.1939, 0.7196, 0.0], [1.1935, -0.6943, -0.0001],
    [0.0025, -1.4063, -0.0001], [2.4404, -1.4306, -0.0001], [3.4290, -2.0031, 0.0],
    [-2.1577, -1.2205, 0.0], [-2.1393, 1.2535, 0.0001], [-0.0184, 2.5085, 0.0002],
    [2.1301, 1.2735, 0.0], [0.0129, -2.4894, -0.0002],
], dtype=np.float32)


def main(argv=None) -> tuple[float, np.ndarray]:
    ap = argparse.ArgumentParser(prog="python -m gemnet_pytorch_tpu_torch.examples.predict")
    ap.add_argument("directory", help="pretrained directory holding model_kwargs.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    model = load_pretrained(args.directory, device=args.device)
    cfg = model.cfg
    molecule = Molecule(R, Z, cutoff=cfg.cutoff, int_cutoff=cfg.int_cutoff,
                        triplets_only=cfg.triplets_only)
    energy, forces = GemNetCalculator(molecule, model, device=args.device).calculate()
    print("Energy [eV]:", energy)
    print("Forces [eV/A]:\n", forces)
    return energy, forces


if __name__ == "__main__":
    main()
