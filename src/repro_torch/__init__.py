"""repro_torch: the PyTorch/CUDA port of the RTNN neighbor search.

It mirrors the JAX package ``repro`` file for file and imports nothing
from it, nor JAX. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""
