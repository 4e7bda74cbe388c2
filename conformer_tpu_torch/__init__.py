"""PyTorch/CUDA port of conformer_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``models/attention.py`` here is the
counterpart of ``conformer_tpu/models/attention.py``, and so on) and takes
the same parameter pytrees (see ``params.py``). Imports torch, numpy and
scipy only: nothing of JAX and nothing of ``conformer_tpu``.
"""
