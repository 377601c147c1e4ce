"""PyTorch/CUDA port of the repro package.

Mirrors ``repro``'s module paths. Imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise.
"""
