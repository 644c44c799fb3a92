"""Dataset containers: npz-backed molecule collections and single-molecule
inputs for serving (copy of `gemnet_pytorch_tpu/data/containers.py`)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .graph import GraphArrays, build_graph
from .padding import PadDims, pad_batch, scale_graph_dims


class DataContainer:
    """npz-backed dataset (keys N, Z, R, F, E; reference
    data_container.py:61,93-113) with on-the-fly padded-batch construction."""

    def __init__(
        self,
        path: str,
        cutoff: float,
        int_cutoff: float,
        triplets_only: bool = False,
    ):
        self.cutoff = cutoff
        self.int_cutoff = int_cutoff
        self.triplets_only = triplets_only
        with np.load(path, allow_pickle=True) as data:
            self.N = data["N"].astype(np.int64)
            self.Z = data["Z"].astype(np.int32)
            self.R = data["R"].astype(np.float32)
            self.F = data["F"].astype(np.float32) if "F" in data else None
            self.E = data["E"].astype(np.float32)
        assert len(self.E) > 0
        if self.E.ndim == 1:
            self.E = self.E[:, None]
        self.N_cumsum = np.concatenate([[0], np.cumsum(self.N)])

    def __len__(self) -> int:
        return len(self.N)

    def gather_molecules(self, idx: Sequence[int]):
        """Concatenate raw per-molecule arrays for the given molecule ids."""
        idx = np.asarray(idx, dtype=np.int64)
        segs = [np.arange(self.N_cumsum[i], self.N_cumsum[i + 1]) for i in idx]
        atom_idx = np.concatenate(segs) if segs else np.zeros(0, dtype=np.int64)
        N = self.N[idx]
        Z = self.Z[atom_idx]
        R = self.R[atom_idx]
        F = self.F[atom_idx] if self.F is not None else np.zeros((len(atom_idx), 3), np.float32)
        E = self.E[idx]
        return N, Z, R, E, F

    def build(self, idx: Sequence[int]) -> tuple[GraphArrays, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Canonical (unpadded) batch graph for molecule ids."""
        N, Z, R, E, F = self.gather_molecules(idx)
        g = build_graph(R, N, self.cutoff, self.int_cutoff, triplets_only=self.triplets_only)
        return g, Z, R, E, F

    def get_padded(self, idx: Sequence[int], dims: PadDims) -> dict[str, np.ndarray]:
        """Padded static-shape batch (model inputs + targets + masks)."""
        g, Z, R, E, F = self.build(idx)
        return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=self.triplets_only)


class Molecule:
    """Single-molecule container for serving (reference ase_calculator.py:23-99).

    Positions are mutable; the graph is rebuilt on every `get`, since it
    changes as atoms move. The padded dims grow with 25% headroom, so small
    moves keep the batch shapes stable.
    """

    def __init__(
        self,
        R: np.ndarray,
        Z: np.ndarray,
        cutoff: float,
        int_cutoff: float,
        triplets_only: bool = False,
        dims: Optional[PadDims] = None,
    ):
        assert R.shape == (len(Z), 3)
        self.R = np.asarray(R, dtype=np.float32)
        self.Z = np.asarray(Z, dtype=np.int32)
        self.cutoff = cutoff
        self.int_cutoff = int_cutoff
        self.triplets_only = triplets_only
        self.dims = dims

    def update(self, R: np.ndarray) -> None:
        assert R.shape == self.R.shape
        self.R = np.asarray(R, dtype=np.float32)

    def get(self) -> dict[str, np.ndarray]:
        """Padded model inputs for the current positions."""
        N = np.array([len(self.Z)], dtype=np.int64)
        g = build_graph(self.R, N, self.cutoff, self.int_cutoff, triplets_only=self.triplets_only)
        if self.dims is None or not self.dims.fits(g, 1, len(self.Z)):
            base = self.dims or PadDims(
                n_mol=1,
                n_atoms=16,
                n_edges=128,
                n_triplets=256,
                kmax3=4,
                n_int_edges=0 if self.triplets_only else 64,
                n_intm=0 if self.triplets_only else 256,
                n_quads=0 if self.triplets_only else 512,
                kmax4=0 if self.triplets_only else 4,
            )
            self.dims = base.grow_to(scale_graph_dims(g, 1.25), 1, len(self.Z))
        return pad_batch(g, self.Z, self.R, self.dims, triplets_only=self.triplets_only)
