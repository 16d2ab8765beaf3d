"""Deterministic synthetic data: the JAX package's Philox pipeline."""

from .pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
