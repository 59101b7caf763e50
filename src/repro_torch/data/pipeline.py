"""Data pipeline: synthetic batches moved to the run's device (port of
``repro.data.pipeline.DataPipeline``).

With ``rows`` (a data-parallel run: the Trainer's ``batch_rows``), each
rank draws the **global** batch (``host_index=0``, ``host_count=1``, the
stream of a single process) and keeps the rows ``rows(batch)`` names, so a
data-parallel run trains on exactly the batches a single process would:
the reference's mesh run is one process that splits the global batch the
same way.  Only the rank's rows reach the device.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import batch_iterator


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
        rows: Optional[Callable[[int], object]] = None,
    ):
        # raises when the batch does not divide over the ranks
        self.rows = slice(None) if rows is None else rows(batch)
        self.rows_of = rows
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = torch.device(device)
        self.prefetch = prefetch
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
            prefetch=self.prefetch, rows=self.rows_of,
        )
