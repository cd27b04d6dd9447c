"""Observability, writer side: span records in the JAX package's format."""

from .trace import records_emitted, serve_span, span, trace_enabled, tracer

__all__ = ["records_emitted", "serve_span", "span", "trace_enabled", "tracer"]
