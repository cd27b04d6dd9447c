"""The Llama decoder (``llama.py``) and the JAX-tree loader (``convert.py``)."""
