"""The port's data pipeline (``repro.data``, numpy)."""
from .pipeline import DataConfig, SyntheticLMDataset

__all__ = ["DataConfig", "SyntheticLMDataset"]
