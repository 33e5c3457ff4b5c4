"""stream_matmul — the paper's MM kernel as a CUDA kernel (``csrc/matmul.cu``).

Port of ``repro.kernels.stream_matmul``: ``C = A @ B`` with an fp32
accumulator, A streamed (one block of rows), B a resident weight.  The
CUDA kernel is a shared-memory-tiled SIMT product whose K step follows the
segment's MM parallelism through ``reduction_tile``, as the reference's
Pallas reduction tile does.  ``siren_layer`` runs the same kernel with a
bias + sine epilogue.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (check_cuda_f32, check_launch,
                                        load_library, refuse_dtensor,
                                        stream_handle)

# largest K step the kernel's shared-memory tile holds (csrc/matmul.cu MM_TK)
MAX_BK = 32


def reduction_tile(bk: int, mm_parallel: int | None) -> int:
    """Map the HardwareConfig MM parallelism factor onto the reduction tile:
    the dataflow model's initiation interval is ceil(K / mm_parallel), and
    the kernel reduces bk elements of K per step, so bk tracks mm_parallel
    (rounded up to 8)."""
    if mm_parallel is None:
        return bk
    return min(bk, max(8, -(-int(mm_parallel) // 8) * 8))


def launch_matmul(name: str, a, b, bias, *, w0: float, apply_sin: bool,
                  mm_parallel: int | None):
    """Launch csrc/matmul.cu on CUDA tensors: ``a @ b [+ bias] [-> sin]``."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"{name}: {tuple(a.shape)} @ {tuple(b.shape)}")
    tensors = {"a": a, "b": b}
    if bias is not None:
        if tuple(bias.shape) != (N,):
            raise ValueError(f"{name}: bias must be [{N}], got "
                             f"{tuple(bias.shape)}")
        tensors["bias"] = bias
    check_cuda_f32(name, a.device, **tensors)
    out = torch.empty((M, N), device=a.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = load_library()
    rc = lib.rt_matmul(a.data_ptr(), b.data_ptr(),
                       bias.data_ptr() if bias is not None else None,
                       out.data_ptr(), M, N, K,
                       reduction_tile(MAX_BK, mm_parallel), float(w0),
                       int(apply_sin), stream_handle(a.device))
    check_launch(rc, name)
    return out


def stream_matmul_plain(a, b):
    return a @ b


def stream_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  mm_parallel: int | None = None):
    """C = A @ B.  A: [M, K], B: [K, N].  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    refuse_dtensor("stream_matmul", a, b)
    if a.device.type == "cpu":
        return stream_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"stream_matmul: unsupported device {a.device}")
    return launch_matmul("stream_matmul", a, b, None, w0=1.0,
                         apply_sin=False, mm_parallel=mm_parallel)
