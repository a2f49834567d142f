"""Serving facades of the port (``PairwiseService``, similarity path)."""

from .engine import PairwiseService

__all__ = ["PairwiseService"]
