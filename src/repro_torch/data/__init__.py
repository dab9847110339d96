"""The DaphneSched-scheduled data pipeline (the port's copy of
``repro/data``)."""

from .pipeline import DataPipeline, SyntheticCorpus

__all__ = ["DataPipeline", "SyntheticCorpus"]
