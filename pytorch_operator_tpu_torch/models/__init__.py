"""The Llama decoder (``llama.py``), ResNet (``resnet.py``), ViT (``vit.py``)
and the JAX-tree loaders (``convert.py``)."""
