"""The synthetic LM data pipeline (port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticLMData  # noqa: F401
