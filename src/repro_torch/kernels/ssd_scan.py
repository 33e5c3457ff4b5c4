"""ssd_scan — the Mamba2 inter-chunk state recurrence (``csrc/ssd_scan.cu``)
and its backward (``ssd_scan_bwd_kernel`` in the same source).

Port of ``repro.kernels.ssd_scan``: ``S_c = decay_c * S_{c-1} + states_c``
with ``S_{-1} = 0``, emitting ``prev[c] = S_{c-1}`` (the state each chunk's
off-diagonal term consumes).  states: [BH, NC, P, N] in any float type;
chunk_decay: [BH, NC]; prev: [BH, NC, P, N] float32.

``ssd_scan_plain`` is the port of ``repro/kernels/ref.py::ssd_scan``; CPU
tensors take it.  On CUDA tensors the wrapper launches the kernel or
raises.  ``models/layers.py::ssd_chunked`` calls it for the inter-chunk
recurrence of every mamba layer's prefill (mamba2, jamba); ``kernels/ops.py``
exports it, as in the reference.

Under autograd (grad enabled and an input requiring grad) the wrapper is a
``torch.autograd.Function`` that saves ``prev`` and the decay; its backward
``ssd_scan_bwd`` runs the recurrence's adjoint backwards over the chunks
(the reference differentiates a ``lax.scan`` through XLA, so the backward
kernel has no Pallas counterpart):
``G_{NC-1} = 0``, ``G_c = dprev[c+1] + decay_{c+1} G_{c+1}``,
``dstates[c] = G_c`` and ``ddecay[c] = sum_{p,n} G_c * prev[c]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import ABI, check_launch, load_library, \
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
    version; CUDA tensors the kernel.  Differentiable in both inputs."""
    _check_shapes(states, chunk_decay)
    if torch.is_grad_enabled() and (states.requires_grad
                                    or chunk_decay.requires_grad):
        return _Scan.apply(states, chunk_decay)
    return _scan(states, chunk_decay)


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, states, chunk_decay):
        prev = _scan(states, chunk_decay)
        ctx.save_for_backward(prev, chunk_decay)
        ctx.states_dtype = states.dtype
        return prev

    @staticmethod
    def backward(ctx, dprev):
        prev, chunk_decay = ctx.saved_tensors
        dstates, ddecay = ssd_scan_bwd(dprev, prev, chunk_decay,
                                       ctx.states_dtype)
        return dstates, ddecay.to(chunk_decay.dtype)


def _scan(states, chunk_decay):
    if states.device.type == "cpu":
        return ssd_scan_plain(states, chunk_decay)
    if states.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {states.device}")
    if states.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: states must be float32, bfloat16 or "
                        f"float16, got {states.dtype}")
    _check_device(states, chunk_decay)
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


def _check_device(states, chunk_decay):
    if states.device.index != torch.cuda.current_device() or \
            chunk_decay.device != states.device:
        raise ValueError(f"ssd_scan: states on {states.device}, decay on "
                         f"{chunk_decay.device}, current device "
                         f"cuda:{torch.cuda.current_device()}")


def ssd_scan_bwd_plain(dprev, prev, chunk_decay, dtype=torch.float32):
    """(dstates in ``dtype``, ddecay float32) of the recurrence, a reverse
    loop over the chunk axis in float32: G_c = dprev[c+1] + decay_{c+1}
    G_{c+1} (G_{NC-1} = 0), dstates[c] = G_c, ddecay[c] = sum G_c
    prev[c]."""
    _check_shapes(prev, chunk_decay)
    BH, NC, P, N = prev.shape
    dec = chunk_decay.to(torch.float32)
    dprev = dprev.to(torch.float32)
    g = torch.zeros((BH, P, N), dtype=torch.float32, device=prev.device)
    dstates = torch.empty((BH, NC, P, N), dtype=torch.float32,
                          device=prev.device)
    ddecay = torch.empty((BH, NC), dtype=torch.float32, device=prev.device)
    for c in reversed(range(NC)):
        if c + 1 < NC:
            g = dprev[:, c + 1] + dec[:, c + 1, None, None] * g
        dstates[:, c] = g
        ddecay[:, c] = (g * prev[:, c]).sum((1, 2))
    return dstates.to(dtype), ddecay


def ssd_scan_bwd(dprev: torch.Tensor, prev: torch.Tensor,
                 chunk_decay: torch.Tensor, dtype=torch.float32):
    """(dstates [BH, NC, P, N] in ``dtype``, ddecay [BH, NC] float32) from
    the gradient of prev and the forward's prev and decay.  CPU tensors
    take the plain version; CUDA tensors the kernel (P·N <= 32,768, NC <=
    ``ABI["ssd_bwd_max_nc"]``)."""
    _check_shapes(prev, chunk_decay)
    if tuple(dprev.shape) != tuple(prev.shape):
        raise ValueError(f"ssd_scan_bwd: dprev {tuple(dprev.shape)} != prev "
                         f"{tuple(prev.shape)}")
    if prev.device.type == "cpu":
        return ssd_scan_bwd_plain(dprev, prev, chunk_decay, dtype)
    if prev.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {prev.device}")
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan_bwd: dstates must be float32, bfloat16 "
                        f"or float16, got {dtype}")
    _check_device(prev, chunk_decay)
    BH, NC, P, N = prev.shape
    if P * N > 32 * 1024 or NC > ABI["ssd_bwd_max_nc"]:
        raise ValueError(f"ssd_scan_bwd: [BH, NC, P, N] = "
                         f"{tuple(prev.shape)} needs P·N <= 32768 and NC <= "
                         f"{ABI['ssd_bwd_max_nc']}")
    dprev = dprev.to(torch.float32).contiguous()
    prev = prev.to(torch.float32).contiguous()
    dec = chunk_decay.to(torch.float32).contiguous()
    dstates = torch.empty((BH, NC, P, N), dtype=dtype, device=prev.device)
    ddecay = torch.empty((BH, NC), dtype=torch.float32, device=prev.device)
    if dstates.numel() == 0:
        return dstates, ddecay.zero_()
    rc = load_library().rt_ssd_scan_bwd(
        dprev.data_ptr(), prev.data_ptr(), dec.data_ptr(),
        dstates.data_ptr(), ddecay.data_ptr(), _DTYPES[dtype], BH, NC,
        P * N, stream_handle(prev.device))
    check_launch(rc, "ssd_scan_bwd")
    return dstates, ddecay
