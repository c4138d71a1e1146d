"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Nothing is built when this module is
imported: the first CUDA launch builds every kernel, one nvcc process per
source, all started together, into `build/` at the root of the checkout.
Libraries are named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.

Every C entry point takes raw device pointers and, last, the CUDA stream
as `void*`, launches on that stream without synchronising, and returns
`cudaGetLastError()`; `launch` passes PyTorch's current stream and
raises if that is not 0.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
KERNELS = ("fps", "ball_query", "sa_gather_mlp", "mlp_maxpool", "sa_train_stats",
           "groupall_layer", "contact_scan")  # the sources, one library each
# shared memory one block may use on H100 (227 KB)
MAX_SMEM_BYTES = 232448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> (source, C symbol, argument types); the last argument is the stream
SIGNATURES = {
    "fps": ("fps", "gaddpg_fps", (_P, _I, _I, _I, _P, _P)),
    "ball_query": ("ball_query", "gaddpg_ball_query", (_P, _P, _I, _I, _I, _F, _I, _I, _P, _P)),
    "sa_gather_mlp": ("sa_gather_mlp", "gaddpg_sa_gather_mlp", (_P,) * 11 + (_I,) * 8 + (_P,)),
    "mlp_maxpool": ("mlp_maxpool", "gaddpg_mlp_maxpool", (_P,) * 6 + (_I,) * 4 + (_P,)),
    "sa_train_layer": ("sa_train_stats", "gaddpg_sa_train_layer",
                       (_P,) * 18 + (_I,) * 7 + (_P,)),
    "bn_from_sums": ("sa_train_stats", "gaddpg_bn_from_sums", (_P,) * 7 + (_I,) + (_P,)),
    "sa_train_pool": ("sa_train_stats", "gaddpg_sa_train_pool", (_P,) * 5 + (_I,) * 4 + (_P,)),
    "groupall_layer": ("groupall_layer", "gaddpg_groupall_layer", (_P,) * 14 + (_I,) * 4 + (_P,)),
    "weight_pack": ("groupall_layer", "gaddpg_weight_pack", (_P, _I, _I, _P, _P)),
    "groupall_pool": ("groupall_layer", "gaddpg_groupall_pool", (_P,) * 4 + (_I,) * 3 + (_P,)),
    "contact_scan": ("contact_scan", "gaddpg_contact_scan", (_P,) * 10 + (_I,) * 4 + (_P,)),
}

_lock = threading.Lock()
_functions = {}
# kernel -> nvcc/ptxas output of its build in this process (registers,
# shared memory, spills); empty until a build ran
build_logs = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _library_paths() -> dict:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    return {name: BUILD_DIR / f"{name}-{tag}.so" for name in KERNELS}


def build_all() -> dict:
    """Compile every kernel whose library is missing, all at once, and
    load them all. Returns {kernel: library path}. Raises on any nvcc
    failure with the compiler's output."""
    with _lock:
        paths = _library_paths()
        missing = [n for n, p in paths.items() if not p.exists()]
        if missing:
            BUILD_DIR.mkdir(exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            try:
                for name in missing:
                    tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
                    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                    procs[name] = (tmp, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True))
                failed = []
                for name, (tmp, proc) in procs.items():
                    build_logs[name] = proc.communicate()[0]
                    if proc.returncode:
                        failed.append(f"--- {name}.cu ---\n{build_logs[name]}")
                    else:
                        os.replace(tmp, paths[name])
            finally:
                for _, proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name, (source, symbol, argtypes) in SIGNATURES.items():
            if name not in _functions:
                lib = ctypes.CDLL(str(paths[source]))
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                err_str = lib.gaddpg_error_string
                err_str.argtypes = (ctypes.c_int,)
                err_str.restype = ctypes.c_char_p
                _functions[name] = (fn, err_str)
        return paths


def kernel_device(name: str, *tensors) -> torch.device:
    """The device all `tensors` lie on: "cpu" (the caller then runs the
    plain version) or a CUDA device whose tensors are all contiguous.
    Raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")
    return dev


def launch(name: str, device: torch.device, *args) -> None:
    """Launch C entry `name` (a key of SIGNATURES) on `device`'s current stream with `args`
    (pointers as ints, then the C entry's other arguments); raises
    RuntimeError if the launch reported an error."""
    if name not in _functions:
        build_all()
    fn, err_str = _functions[name]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: error {err} "
            f"({err_str(err).decode()})"
        )
