"""Device choice and the native kernel library, decided in one place.

Device: entry points (`TwinServer`, `FleetMerinda`) take an explicit
``device``.  ``None`` means the CUDA card and RAISES when there is none: the
port never carries on silently on the CPU.  Passing ``"cpu"`` selects the
plain PyTorch versions of the kernels (what the tests do).

Kernels: the hand-written CUDA sources under ``repro_torch/csrc`` are built
at first use with ``nvcc`` into ONE shared library with a plain C interface
and loaded with ``ctypes``.  Each source is compiled to an object by its own
``nvcc`` process, all started together, then the objects are linked.  The
build directory (``build/repro_torch/<hash>`` at the checkout root, listed in
``.gitignore``) is keyed on a hash of the sources and flags, so a stale
library is never loaded.  Nothing here runs at import: the CPU tests import
every module on a machine with no ``nvcc``.

Each kernel wrapper (kernels/gru/ops.py, kernels/rk4/ops.py,
kernels/linear_scan/ops.py) dispatches on the device of the tensors it is
given: a CPU tensor goes to the plain version, a CUDA tensor launches the
kernel or raises.  A build or launch
failure is never caught and routed to the plain version.

A META tensor (the dry-run's trace, launch/opcount.py) takes the card's
route through the wrapper's `autograd.Function`, so its saved tensors and
backward are the card's; in place of each launch (a forward, or the RK4
adjoint in a backward) the wrapper only shapes its outputs and reports the
kernel's work (kernels/work.py) to the sinks registered with `meta_sink`.
It is not counted as a launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["resolve_device", "build_library", "load_library", "check_cuda",
           "cuda_stream", "meta_sink", "meta_kernel", "ARCH_FLAGS",
           "MAX_SMEM"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
_LIB_NAME = "librepro_torch_kernels.so"
MAX_SMEM = 232448      # dynamic shared memory a Hopper block may opt into

_lib = None
_lib_lock = threading.Lock()
_meta_sinks: list = []


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else is taken as given (``"cpu"`` runs the plain PyTorch path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Start every command at once, wait for all, raise on any failure;
    returns each command's combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failures = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return outs


def build_library(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library (no-op when the hashed
    build already exists); returns its path.  `verbose` prints ptxas's
    register / shared-memory / spill report for each kernel."""
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / _build_key(nvcc)
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs = [tmp / (src.stem + ".o") for src in _sources()]
        outs = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o",
                          str(obj)] for src, obj in zip(_sources(), objs)])
        if verbose:
            print("".join(outs), end="")
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / _LIB_NAME),
                   *map(str, objs)]])
        os.replace(tmp / _LIB_NAME, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def _declare(lib) -> None:
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.gru_scan_launch.argtypes = [vp] * 7 + [i32] * 5 + [vp]
    lib.gru_scan_launch.restype = i32
    lib.gru_scan_max_hidden.argtypes = [i32]
    lib.gru_scan_max_hidden.restype = i32
    lib.rk4_poly_launch.argtypes = [vp] * 5 + [i32] * 6 + [f64, vp]
    lib.rk4_poly_launch.restype = i32
    lib.rk4_adjoint_launch.argtypes = [vp] * 8 + [i32] * 6 + [f64, vp]
    lib.rk4_adjoint_launch.restype = i32
    lib.rk4_poly_max_n.argtypes = []
    lib.rk4_poly_max_n.restype = i32
    lib.rk4_poly_max_aug.argtypes = []
    lib.rk4_poly_max_aug.restype = i32
    lib.linear_scan_launch.argtypes = [vp] * 10 + [i32] * 8 + [vp]
    lib.linear_scan_launch.restype = i32
    lib.linear_scan_smem_bytes.argtypes = [i32] * 3
    lib.linear_scan_smem_bytes.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def load_library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            _declare(lib)
            _lib = lib
        return _lib


def check_cuda(lib, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def cuda_stream(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


@contextlib.contextmanager
def meta_sink(fn):
    """Within the block, fn(name, flops=, tf32_flops=, nbytes=) hears of
    every kernel a meta trace reaches (in place of its launch)."""
    _meta_sinks.append(fn)
    try:
        yield fn
    finally:
        _meta_sinks.remove(fn)


def meta_kernel(name: str, *, flops: float, nbytes: float,
                tf32_flops: float = 0.0) -> None:
    """A kernel reached on meta tensors: tell the registered sinks its
    work (f32 operations, TF32 ones, bytes read and written)."""
    for fn in list(_meta_sinks):
        fn(name, flops=flops, tf32_flops=tf32_flops, nbytes=nbytes)
