"""The kernel library's public entry point, as ``repro.kernels.ops`` is.

Each name is the port's wrapper: its CUDA kernel on CUDA tensors, its plain
PyTorch version on CPU tensors.  ``ref`` holds the plain versions, as the
reference's ``repro.kernels.ref`` holds its pure-jnp oracles.  PyTorch runs
eagerly, so there is no counterpart of the reference's ``jax.jit``.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fused_chain import eval_chain, fused_chain
from repro_torch.kernels.siren_layer import siren_layer, siren_layer_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.kernels.stream_matmul import (stream_matmul,
                                               stream_matmul_plain)


def _fused_chain_plain(x, chain, extras=()):
    return eval_chain(x.float(), tuple(chain), extras).to(x.dtype)


ref = SimpleNamespace(stream_matmul=stream_matmul_plain,
                      siren_layer=siren_layer_plain,
                      fused_chain=_fused_chain_plain,
                      flash_attention=flash_attention_plain,
                      ssd_scan=ssd_scan_plain)

__all__ = ["stream_matmul", "siren_layer", "fused_chain", "flash_attention",
           "ssd_scan", "ref"]
