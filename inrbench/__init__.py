"""The benchmark of ``repro_torch`` on a CUDA card (see README.md)."""
