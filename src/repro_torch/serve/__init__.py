"""Serving facades of the port: ``PairwiseService`` (similarity path) and
``BatchedServer`` (LM wave decoding)."""

from .engine import BatchedServer, PairwiseService, Request

__all__ = ["BatchedServer", "PairwiseService", "Request"]
