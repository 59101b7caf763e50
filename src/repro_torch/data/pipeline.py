"""Single-device data pipeline: synthetic batches moved to one device.

The single-device part of ``repro.data.pipeline.DataPipeline``; sharded
placement over a mesh is not ported (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator

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
    ):
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
                {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
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
            prefetch=self.prefetch,
        )
