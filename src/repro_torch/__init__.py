"""PyTorch/CUDA port of the LUT Tensor Core serving stack.

Mirrors the layout of the JAX package ``repro`` module for module, so each
function here has a counterpart of the same name there. The port imports
neither JAX nor ``repro``: the tests import both and compare them on the
same inputs. The three LUT mpGEMM kernels are hand-written CUDA for Hopper
(``csrc/``), built with ``nvcc`` at first use (``kernels/_build.py``).
"""
