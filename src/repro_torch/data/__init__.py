from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import (
    IGNORE,
    SyntheticLM,
    batch_iterator,
    lm_batch,
    make_batch,
    mlm_batch,
)

__all__ = [
    "DataPipeline",
    "IGNORE",
    "SyntheticLM",
    "batch_iterator",
    "lm_batch",
    "make_batch",
    "mlm_batch",
]
