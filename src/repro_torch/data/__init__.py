"""Training data: the synthetic corpus and the FLIC-cached pipeline."""
from repro_torch.data.pipeline import DataConfig, DataPipeline, synthetic_batch

__all__ = ["DataConfig", "DataPipeline", "synthetic_batch"]
