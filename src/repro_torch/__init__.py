"""PyTorch/CUDA port of the INR-Arch gradient compiler (``repro``).

Imports torch and numpy, never JAX or the ``repro`` package.  Entry point:
``repro_torch.core.pipeline.compile_gradient``.
"""
