"""Build, load and launch the port's hand-written CUDA kernels.

Each `kernels/<name>.cu` is compiled on first use with nvcc for sm_90a into
a shared library with a plain C interface, cached under `kernels/_build/`
by a hash of the source, the headers beside it and the flags (a changed
source gets a new file),
and loaded with ctypes. No PyTorch headers are compiled, so a build takes
seconds, and no ninja is needed.

Every launcher takes raw device pointers, sizes and the stream, and returns
cudaGetLastError(); `launch` raises on a nonzero code and counts the launch.
A build or launch failure is raised, never answered with the plain torch
version: the plain version runs only for tensors on the CPU.
"""
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-shared"]

# kernel name -> launches since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {}
# source name -> seconds nvcc took in this process (absent: loaded from cache)
BUILD_SECONDS: Dict[str, float] = {}
# source name -> what ptxas -v said of each kernel it compiled in this
# process: (kernel name with its template arguments, registers a thread,
# spill stores and loads in bytes, static shared memory in bytes)
BUILD_RESOURCES: Dict[str, List[Tuple[str, int, int, int, int]]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel did not build, load or launch."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def kernel_label(mangled: str) -> str:
    """`sw_extend_kernel<5>` from the mangled name ptxas prints: the last of
    its nested length-prefixed identifiers, with its template arguments
    where they are int, long or unsigned char types or integer or bool
    literals."""
    m = re.match(r"_ZN?", mangled)
    label, rest = None, mangled[m.end():] if m else ""
    while True:  # nested names, each prefixed with its length
        m = re.match(r"\d+", rest)
        if not m or len(rest) < m.end() + int(m.group()):
            break
        label = rest[m.end():m.end() + int(m.group())]
        rest = rest[m.end() + int(m.group()):]
    if label is None:
        return mangled
    t = re.match(r"I((?:[ilh]|L[ib]\d+E)+)E", rest)
    if t:
        args = [{"i": "int", "l": "long", "h": "unsigned char", "Lb0E": "false",
                 "Lb1E": "true"}.get(a, a[2:-1])
                for a in re.findall(r"[ilh]|L[ib]\d+E", t.group(1))]
        label += "<" + ", ".join(args) + ">"
    return label


def ptxas_resources(log: str) -> List[Tuple[str, int, int, int, int]]:
    """The kernels of one `ptxas -v` log: (name, registers, spill store
    bytes, spill load bytes, static shared bytes) for each entry function."""
    found = []
    name, spills = None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = kernel_label(m.group(1)), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            sm = re.search(r"(\d+) bytes smem", line)
            found.append((name, int(m.group(1)), *spills,
                          int(sm.group(1)) if sm else 0))
            name = None
    return found


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load kernels/<name>.cu; declare each launcher
    in `signatures` (function name -> argtypes) with an int return."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = os.path.join(_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and the headers beside it, which any source may include
    for path in [src] + sorted(glob.glob(os.path.join(_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise KernelError(f"nvcc failed on {name}.cu:\n{r.stderr[-6000:]}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads a torn file
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_RESOURCES[name] = ptxas_resources(r.stderr)
    lib = ctypes.CDLL(so)
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes) + [ctypes.c_void_p]  # + the stream
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(lib: ctypes.CDLL, fn: str, kernel: str, device: torch.device,
           *args) -> None:
    """Call launcher `fn` on `device`'s current stream, raise on a CUDA
    error, and count one launch of `kernel`."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise KernelError(f"{fn}: CUDA error {rc} ({msg})")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """The one device of `tensors`, which must be CUDA and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"kernel launched on {dev}")
    return dev


def check_lanes(n: int, *vectors: torch.Tensor) -> None:
    """Each per-lane vector holds exactly n entries: a kernel reads n."""
    for v in vectors:
        if v.dim() != 1 or v.numel() != n:
            raise ValueError(f"per-lane input of shape {tuple(v.shape)}, "
                             f"expected ({n},)")


def route(t: torch.Tensor) -> str:
    """'kernel' for a CUDA tensor, 'plain' for a CPU one; anything else
    raises. An op picks its implementation from this alone."""
    if t.device.type == "cuda":
        return "kernel"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no implementation for device {t.device}")
