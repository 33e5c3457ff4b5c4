"""Devices, the CUDA kernel library, and launch bookkeeping.

Every kernel of the port is CUDA C++ under ``csrc/``.  ``nvcc`` compiles
each source (one process per source, all started together) for ``sm_90a``
and links them into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The library is built at first use into
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing build.  Nothing is built or loaded at import time: a process
that only uses CPU tensors never needs ``nvcc``.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors; it adds one to ``LAUNCHES[name]``
right after a launch that the runtime accepted, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# no --use_fast_math: __sinf is far off for the |30 h| arguments SIREN feeds
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES: collections.Counter = collections.Counter()

# constants the Python side shares with csrc/abi.cuh, checked at load time
ABI = {"region_rows": 8, "region_threads": 256, "region_instr_ints": 96,
       "max_ptrs": 96, "max_chain": 32, "max_extra": 16, "n_chain_ops": 18,
       "region_red_floats": 2048, "smem_dynamic_bytes": 231424,
       "max_lanes": 65535, "region_bwd_io_ints": 4, "fa_bq": 64, "fa_bk": 32,
       "fa_tc_bq": 128, "fa_tc_bk": 128, "fa_tc_bk_wide": 64,
       "region_wstage_floats": 8192, "region_wring": 2,
       "region_max_cluster": 16, "row_cluster": 2,
       "rows_stages": 2, "row_groups": 4, "col_tile": 4, "chunk_ints": 5,
       "design_ints": 7, "rows_consumers": 256, "sm_smem_bytes": 233472,
       "smem_static": 1024, "chain_rows": 8, "chain_cols": 16,
       "ssd_bwd_max_nc": 1792}

_LIB = None
_LOCK = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reset_launches() -> None:
    LAUNCHES.clear()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Without CUDA, a call that did not ask for the CPU raises
    instead of carrying on there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available")
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got "
                         f"{device!r}")
    return dev


def fp32_strict() -> None:
    """Keep float32 products in full float32: TF32 keeps about three
    digits, and SIREN's w0 = 30 amplifies pre-activation error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "repro_torch are built at first use")


def _source_tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into ``build/repro_torch/`` unless a build of
    the same sources exists; returns the library's path."""
    tag = _source_tag()
    lib = BUILD_DIR / f"librepro_torch_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        log = BUILD_DIR / f"{src.stem}_{tag}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src),
                                     "-o", str(obj)],
                                    stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((proc, src, obj, log))
    failed = []
    for proc, src, _, log in jobs:
        if proc.wait() != 0:
            failed.append(f"{src.name}:\n{log.read_text()[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *(str(o) for _, _, o, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    return lib


def build_logs() -> dict[str, str]:
    """``ptxas -v`` output of the current build, by source name."""
    tag = _source_tag()
    return {p.name.rsplit("_", 1)[0]: p.read_text()
            for p in sorted(BUILD_DIR.glob(f"*_{tag}.log"))}


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "rt_abi": ([ctypes.POINTER(_I), _I], _I),
    "rt_error_string": ([_I], ctypes.c_char_p),
    "rt_fused_chain": ([ctypes.c_char_p, ctypes.c_char_p, _VP], _I),
    "rt_launch_floor": ([_I, _I, _VP], _I),
    "rt_matmul": ([_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _I, _VP], _I),
    "rt_region": ([_VP, _VP, _I, _I, _VP, _VP, _I, _LL, _I, _I, _I, _I, _I,
                   _VP, _VP, _VP], _I),
    "rt_region_max_clusters": ([_I, _I, _I, _LL], _I),
    "rt_region_bwd": ([_VP, _VP, _I, _I, _I, _I, _VP, _LL, _I, _I, _I, _I,
                       _I, _I, _I, _VP, _LL, _VP, _VP], _I),
    "rt_region_bwd_max_clusters": ([_I, _LL], _I),
    "rt_region_bwd_reduce": ([_VP, _LL, _LL, _VP, _VP], _I),
    "rt_flash_attention": ([_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                            _I, ctypes.POINTER(_LL), _F, _I, _I, _VP], _I),
    "rt_flash_attention_tc": ([_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                               _I, ctypes.POINTER(_LL), _F, _I, _I, _VP], _I),
    "rt_flash_attention_bwd": ([_VP] * 10 + [_I] * 7 + [_F, _I, _I, _VP],
                               _I),
    "rt_flash_attention_tc_smem": ([_I], _I),
    "rt_flash_attention_tc_encode_ns": ([_VP, _VP, _VP, _I, _I, _I, _I, _I,
                                         _I, ctypes.POINTER(_LL), _I], _LL),
    "rt_ssd_scan": ([_VP, _VP, _VP, _I, _LL, _I, _LL, _VP], _I),
    "rt_ssd_scan_bwd": ([_VP, _VP, _VP, _VP, _VP, _I, _LL, _I, _LL, _VP],
                        _I),
}


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            vals = (ctypes.c_int * len(ABI))()
            lib.rt_abi(vals, len(ABI))
            got = dict(zip(ABI, vals))
            if got != ABI:
                raise RuntimeError(f"csrc/abi.cuh {got} != Python {ABI}")
            _LIB = lib
    return _LIB


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher, then
    count the launch."""
    if rc != 0:
        msg = _LIB.rt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def stream_handle(device: torch.device) -> int:
    """The current stream of ``device`` (a CUDA device with an index), as
    ``torch.cuda.current_stream(device).cuda_stream`` without building the
    Stream object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_cuda_f32(name: str, device: torch.device, **tensors) -> None:
    """Every operand of a CUDA launch: float32, contiguous, on ``device``,
    which is the current device (the launchers launch there)."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
