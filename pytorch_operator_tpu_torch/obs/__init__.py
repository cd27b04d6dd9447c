"""Observability, writer side: span records in the JAX package's format."""

from .trace import serve_span, span, tracer

__all__ = ["serve_span", "span", "tracer"]
