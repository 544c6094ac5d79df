"""dynamo_tpu_torch: the PyTorch/CUDA port of the dynamo_tpu serving engine.

The JAX package ``dynamo_tpu`` stays the reference. This package imports
``torch``, ``numpy`` and the standard library only: it keeps its own
copies of what it needs from the reference and never imports it. Entry
points take a ``device`` argument (default ``"cuda"``) and raise when no
GPU is present; the CPU tests pass ``device="cpu"`` explicitly.
"""
