"""Synthetic data pipeline of the port (counterpart of ``repro.data``)."""

from .pipeline import DataConfig, DataPipeline, host_slice, make_batch

__all__ = ["DataConfig", "DataPipeline", "host_slice", "make_batch"]
