"""Data pipeline: synthetic batches moved to the run's device (port of
``repro.data.pipeline.DataPipeline``).

With a ``mesh``, each rank draws the **global** batch (``host_index=0``,
``host_count=1``, the stream of a single process) and keeps its block of
rows, so a data-parallel run trains on exactly the batches a single
process would: the reference's mesh run is one process that splits the
global batch the same way.  Only the rank's rows reach the device.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import batch_iterator
from repro_torch.sharding.placement import batch_rows


class DataPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        seq: int,
        *,
        device: torch.device,
        seed: int = 0,
        prefetch: int = 2,
        mesh=None,
    ):
        self.rows = slice(None)
        if mesh is not None:   # raises when the batch does not divide
            start, n = batch_rows(batch, mesh)
            self.rows = slice(start, start + n)
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.mesh = mesh
        self._it = batch_iterator(cfg, batch, seq, seed=seed)
        self._buf: collections.deque = collections.deque()

    def _fill(self):
        while len(self._buf) < self.prefetch:
            b = next(self._it)
            self._buf.append(
                {k: torch.from_numpy(v[self.rows]).to(self.device) for k, v in b.items()}
            )

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        self._fill()
        return self._buf.popleft()

    def with_stage(self, batch: int, seq: int) -> "DataPipeline":
        """New pipeline for a mixed-batch stage (fresh shapes, same source)."""
        return DataPipeline(
            self.cfg, batch, seq, device=self.device, seed=self.seed,
            prefetch=self.prefetch, mesh=self.mesh,
        )
