"""Plain PyTorch references, one file a model family. They import
``torch`` only: nothing of the port, the JAX package or the harness."""
