"""Observability, writer side: span records in the JAX package's format."""
