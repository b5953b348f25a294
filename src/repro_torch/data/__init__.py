"""The synthetic LM data stream (torch counterpart of repro/data)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticLMDataset,
    make_batch_iterator,
)
