"""Train/val/test splits and infinite padded-batch iterators (copy of
`gemnet_pytorch_tpu/data/provider.py`).

Equivalent of the reference DataProvider (gemnet/training/data_provider.py:25-174):
random or manual splits, save_split, shuffled infinite generators. Batching
happens in the container (whole index list at once), and every batch is padded
to one static `PadDims`, so every step sees the same shapes. The batches are
numpy dicts; `data.to_torch` (the Trainer does it) puts them on the trainer's
device with their segment plans, or a `transform` (the trainer's
`BatchPacker.pack`) turns each into one packed buffer in the prefetch
threads.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np

from ..perf import spans
from .containers import DataContainer
from .padding import PadDims, estimate_pad_dims, pad_batch, scale_graph_dims

# batches built ahead of the consumer by the prefetch threads
PREFETCH_DEPTH = 4


class DataProvider:
    def __init__(
        self,
        data_container: DataContainer,
        ntrain: int,
        nval: int,
        batch_size: int = 1,
        seed: Optional[int] = None,
        random_split: bool = False,
        shuffle: bool = True,
        sample_with_replacement: bool = False,
        split: Union[None, str, dict] = None,
        pad_dims: Optional[PadDims] = None,
        pad_sample_batches: int = 16,
    ):
        self.data_container = data_container
        self._ndata = len(data_container)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.random_split = random_split
        self.sample_with_replacement = sample_with_replacement
        self._random_state = np.random.RandomState(seed=seed)

        if split is None:
            self.nsamples, self.idx = self._random_split_data(ntrain, nval)
        else:
            self.nsamples, self.idx = self._manual_split_data(split)

        self.pad_dims = pad_dims or self._estimate_dims(pad_sample_batches)

    # -- splits (reference data_provider.py:82-126) --
    def _manual_split_data(self, split):
        keys = ["train", "val", "test"]
        if isinstance(split, str):
            if not split.endswith(".npz"):
                raise ValueError(f"split file {split} is no .npz")
            with np.load(split) as data:
                split = {key: data[key] for key in keys if key in data}
        for key in keys:
            if key not in split:
                raise KeyError(f"{key} missing from split")
        idx = {key: np.asarray(split[key]) for key in keys}
        return {key: len(idx[key]) for key in keys}, idx

    def _random_split_data(self, ntrain, nval):
        nsamples = {"train": ntrain, "val": nval, "test": self._ndata - ntrain - nval}
        all_idx = np.arange(self._ndata)
        if self.random_split:
            all_idx = self._random_state.permutation(all_idx)
        if self.sample_with_replacement:
            all_idx = self._random_state.choice(all_idx, self._ndata, replace=True)
        idx = {
            "train": all_idx[0:ntrain],
            "val": all_idx[ntrain : ntrain + nval],
            "test": all_idx[ntrain + nval :],
        }
        return nsamples, idx

    def save_split(self, path: str) -> None:
        if not path.endswith(".npz"):
            raise ValueError(f"split file {path} is no .npz")
        np.savez(path, **self.idx)

    # -- static-shape selection --
    def _estimate_dims(self, n_batches: int) -> PadDims:
        """Scan sample batches to size the static padded shapes."""
        rng = np.random.RandomState(0)
        graphs, natoms = [], []
        pool = np.arange(self._ndata)
        for _ in range(n_batches):
            sel = rng.choice(pool, size=min(self.batch_size, self._ndata), replace=False)
            g, Z, R, E, F = self.data_container.build(sel)
            graphs.append(g)
            natoms.append(len(Z))
        return estimate_pad_dims(
            graphs,
            n_mol=self.batch_size,
            n_atoms_list=natoms,
            triplets_only=self.data_container.triplets_only,
            headroom=1.25,
        )

    # -- iteration (reference data_provider.py:137-174) --
    def _build_padded(self, sel: np.ndarray) -> dict[str, np.ndarray]:
        g, Z, R, E, F = self.data_container.build(sel)
        n_mol = len(sel)
        if not self.pad_dims.fits(g, n_mol, len(Z)):
            # rare outlier batch: grow dims (new shapes from then on)
            self.pad_dims = self.pad_dims.grow_to(
                scale_graph_dims(g, 1.25), n_mol, int(len(Z) * 1.25)
            )
            spans.count("pad.grow")
        return self.pad(g, Z, R, E, F, self.pad_dims)

    def pad(self, g, Z, R, E, F, dims: PadDims) -> dict[str, np.ndarray]:
        """A raw batch (`DataContainer.build`'s) padded to `dims`."""
        return pad_batch(g, Z, R, dims, E=E, F=F,
                         triplets_only=self.data_container.triplets_only)

    def _selections(self, split: str, batch_size: int):
        shuffle = self.shuffle if split == "train" else False
        indices = self.idx[split]
        rng = np.random.RandomState(self.seed)
        while True:
            order = rng.permutation(indices) if shuffle else indices
            for i in range(0, len(order), batch_size):
                sel = order[i : i + batch_size]
                if len(sel):
                    yield sel

    def get_dataset(
        self, split: str, batch_size: Optional[int] = None, prefetch_workers: int = 2,
        transform=None, raw_transform=None, shard: Optional[tuple[int, int]] = None,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Infinite padded-batch iterator. With prefetch_workers > 0, batches
        are built by background threads ahead of consumption (numpy padding
        releases the GIL in part), overlapping host-side graph construction
        with device steps — the reference's DataLoader-worker role
        (data_provider.py:164), absent there by default (num_workers=0).
        `transform`, where given, maps each padded batch in the same threads
        (the JAX provider's, provider.py:125-153): the trainer's
        `packer.pack` yields packed int32 rows. `raw_transform(g, Z, R, E, F)`
        instead replaces the padding and receives the raw batched graph (the
        halo partitioner builds its own layout, parallel/halo.py). The spans
        of a batch (`perf.spans`), in the thread that builds it and in the
        consumer's after it is yielded, carry its sequence number.
        `shard=(rank, ranks)`: of the batches every process draws alike,
        this one builds and yields only every ranks-th, from `rank` on
        (data parallelism's shard, `parallel.dp.ShardFeed`)."""
        if split not in self.idx:
            raise KeyError(f"no split {split!r}")
        if transform is not None and raw_transform is not None:
            raise ValueError("pass transform or raw_transform, not both")
        batch_size = batch_size or self.batch_size
        batches = enumerate(self._selections(split, batch_size))
        if shard is not None:
            rank, ranks = shard
            batches = ((seq, sel) for seq, sel in batches if seq % ranks == rank)

        def build(seq, sel):
            spans.tag(seq)
            if raw_transform is not None:
                return raw_transform(*self.data_container.build(sel))
            batch = self._build_padded(sel)
            return transform(batch) if transform is not None else batch

        if prefetch_workers <= 0:
            def generator():
                for seq, sel in batches:
                    yield build(seq, sel)

            return generator()

        from concurrent.futures import ThreadPoolExecutor

        def generator():
            pool = ThreadPoolExecutor(max_workers=prefetch_workers)

            def submit():
                seq, sel = next(batches)
                return seq, pool.submit(build, seq, sel)

            try:
                pending = [submit() for _ in range(PREFETCH_DEPTH)]
                while True:
                    seq, fut = pending.pop(0)
                    pending.append(submit())
                    with spans.span("data.wait", id=seq):
                        batch = fut.result()
                    spans.tag(seq)
                    yield batch
            finally:
                # non-blocking, errors swallowed: the generator may be
                # finalized during interpreter shutdown, where the threading/
                # queue modules are already torn down and any join raises
                try:
                    pool.shutdown(wait=False, cancel_futures=True)
                except Exception:  # noqa: BLE001 (see above)
                    pass

        return generator()
