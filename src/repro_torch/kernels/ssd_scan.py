"""ssd_scan — the Mamba2 inter-chunk state recurrence (``csrc/ssd_scan.cu``).

Port of ``repro.kernels.ssd_scan``: ``S_c = decay_c * S_{c-1} + states_c``
with ``S_{-1} = 0``, emitting ``prev[c] = S_{c-1}`` (the state each chunk's
off-diagonal term consumes).  states: [BH, NC, P, N] in any float type;
chunk_decay: [BH, NC]; prev: [BH, NC, P, N] float32.

``ssd_scan_plain`` is the port of ``repro/kernels/ref.py::ssd_scan``; CPU
tensors take it.  On CUDA tensors the wrapper launches the kernel or
raises.  ``models/layers.py::ssd_chunked`` calls it for the inter-chunk
recurrence of every mamba layer's prefill (mamba2, jamba); ``kernels/ops.py``
exports it, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import check_launch, load_library, \
    stream_handle

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_shapes(states, chunk_decay):
    if states.dim() != 4 or tuple(chunk_decay.shape) != tuple(
            states.shape[:2]):
        raise ValueError(f"ssd_scan: states {tuple(states.shape)} needs "
                         f"[BH, NC, P, N] and chunk_decay [BH, NC], got "
                         f"{tuple(chunk_decay.shape)}")
    if not states.is_floating_point() or not chunk_decay.is_floating_point():
        raise TypeError(f"ssd_scan: float inputs, got {states.dtype} / "
                        f"{chunk_decay.dtype}")


def ssd_scan_plain(states, chunk_decay):
    """prev[c] = S_{c-1};  S_c = decay_c * S_{c-1} + states_c  (S_{-1}=0),
    in float32, a loop over the chunk axis."""
    _check_shapes(states, chunk_decay)
    BH, NC, P, N = states.shape
    dec = chunk_decay.to(torch.float32)
    s = torch.zeros((BH, P, N), dtype=torch.float32, device=states.device)
    prev = torch.empty((BH, NC, P, N), dtype=torch.float32,
                       device=states.device)
    for c in range(NC):
        prev[:, c] = s
        s = s * dec[:, c, None, None] + states[:, c].to(torch.float32)
    return prev


def ssd_scan(states: torch.Tensor, chunk_decay: torch.Tensor) -> torch.Tensor:
    """[BH, NC, P, N] float32 prev-states.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    _check_shapes(states, chunk_decay)
    if states.device.type == "cpu":
        return ssd_scan_plain(states, chunk_decay)
    if states.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {states.device}")
    if states.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: states must be float32, bfloat16 or "
                        f"float16, got {states.dtype}")
    if states.device.index != torch.cuda.current_device() or \
            chunk_decay.device != states.device:
        raise ValueError(f"ssd_scan: states on {states.device}, decay on "
                         f"{chunk_decay.device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    if not states.is_contiguous():
        raise ValueError("ssd_scan: states must be contiguous")
    # the decay is [BH, NC]: read as float32 (exact from bf16 / fp16)
    dec = chunk_decay.to(torch.float32).contiguous()
    BH, NC, P, N = states.shape
    prev = torch.empty((BH, NC, P, N), dtype=torch.float32,
                       device=states.device)
    if prev.numel() == 0:
        return prev
    lib = load_library()
    rc = lib.rt_ssd_scan(states.data_ptr(), dec.data_ptr(), prev.data_ptr(),
                         _DTYPES[states.dtype], BH, NC, P * N,
                         stream_handle(states.device))
    check_launch(rc, "ssd_scan")
    return prev
