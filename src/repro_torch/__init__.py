"""PyTorch/CUDA port of the Froid engine (``src/repro``), for NVIDIA Hopper.

Imports torch, numpy and the standard library only: nothing of JAX and
nothing of the reference package.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
