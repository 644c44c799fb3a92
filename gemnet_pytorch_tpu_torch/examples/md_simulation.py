"""MD example: the counterpart of `examples/md_simulation.py` (the
reference's ase_example.ipynb).

    python -m gemnet_pytorch_tpu_torch.examples.md_simulation [--traj PATH]
        [--steps N] [--device cpu]

A short Langevin simulation (0.5 fs steps at 300 K, a frame every 10 steps)
of a random 10-atom molecule under a small GemNet-T (energy-gradient
forces, random weights from seed 0) through `md.MDSimulator`, written as
an npz trajectory to PATH.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import ModelConfig
from ..data import Molecule
from ..data.synthetic import random_molecule
from ..md import MDSimulator, Trajectory
from ..models import GemNet

CONFIG = ModelConfig(
    num_spherical=7, num_radial=6, num_blocks=2, emb_size_atom=64,
    emb_size_edge=64, emb_size_trip=32, emb_size_quad=16, emb_size_rbf=16,
    emb_size_cbf=16, emb_size_sbf=16, emb_size_bil_quad=16,
    emb_size_bil_trip=32, triplets_only=True, direct_forces=False,
)


def main(argv=None) -> Trajectory:
    ap = argparse.ArgumentParser(prog="python -m gemnet_pytorch_tpu_torch.examples.md_simulation")
    ap.add_argument("--traj", default="md_sim.traj.npz", help="npz trajectory to write")
    ap.add_argument("--steps", type=int, default=100, help="MD steps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    Z, R = random_molecule(np.random.default_rng(0), 10)
    molecule = Molecule(R, Z, cutoff=CONFIG.cutoff, int_cutoff=CONFIG.int_cutoff,
                        triplets_only=True)
    model = GemNet(CONFIG, generator=torch.Generator().manual_seed(0), device=args.device)
    sim = MDSimulator(molecule, model, dynamics="langevin", max_steps=args.steps, time=0.5,
                      temperature=300, interval=10, traj_path=args.traj, device=args.device)
    traj = sim.run()
    print(f"wrote {len(traj)} frames to {args.traj}")
    return traj


if __name__ == "__main__":
    main()
