"""mjrl_tpu_torch — the PyTorch / CUDA port of the ``mjrl_tpu`` package.

The module tree mirrors ``mjrl_tpu`` so that the counterpart of each file is
found under the same name.  Plain tensor code is PyTorch; the planar
whole-control-step physics kernel is hand-written CUDA C++ for Hopper
(``csrc/``, bound in ``ops/cuda_planar.py``).  Importing the package needs
neither a GPU nor ``nvcc``; entry points run on the GPU when one is present
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
