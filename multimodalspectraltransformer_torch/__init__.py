"""PyTorch/CUDA port of the multimodal spectral transformer.

Runs the per-molecule evaluation pipeline (featurize -> encode -> greedy,
fan-out and beam decoding -> chemistry filters -> GNN spectrum simulation ->
batched assignment scoring -> ranking) and the ancestry beam search on an
NVIDIA H100. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; it never falls back to the CPU on its own. The
decode-attention, beam-attention and auction kernels are hand-written CUDA
(``csrc/``), built with plain ``nvcc`` at first use (``ops/_build.py``).

The package imports torch, numpy and scipy only.
"""
