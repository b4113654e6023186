"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and becomes one
shared library, built for ``sm_90a`` at first use into ``_build/`` next to
this file (listed in ``.gitignore``).  The library's file name carries a hash
of its source, of every ``csrc`` header it includes (``#include "…"``, at any
depth) and of ``NVCC_FLAGS`` (every compile and link flag), so an edited
source or header is rebuilt and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them.

Every C entry point takes the CUDA stream as its last argument, launches on
it without synchronising, and returns ``cudaGetLastError()``.  :func:`launch`
passes PyTorch's current stream, raises on a non-zero return, and only then
adds one to the wrapper's count in :data:`launches`.  A wrapper with several
plans (one C entry point each) counts every plan under its own name, so one
wrapper call is one counted launch.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

BACKENDS = ("torch", "cuda")

_PTR, _I64, _F32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_int)
#: library -> C entry point -> argtypes (the stream is the last pointer)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "ota": {
        "ota_modulate": [_PTR] * 7 + [_I64, _F32, _PTR],
        "ota_receive": [_PTR] * 7 + [_I64, _I64, _PTR],
        "ota_receive_split": [_PTR] * 9 + [_I64, _I64, _INT, _I64, _PTR],
        "ota_demodulate_dyn": [_PTR] * 5 + [_I64, _PTR],
        "ota_demodulate": [_PTR] * 4 + [_I64, _F32, _PTR],
        "ota_accumulate": [_PTR] * 8 + [_I64, _PTR],
    },
    "ota_round": {
        "ota_round_stats": [_PTR] * 18 + [_I64, _I64, _INT, _I64, _F32, _F32,
                                          _F32, _INT, _PTR],
        "ota_round_theta": [_PTR] * 17 + [_I64, _I64, _INT, _I64, _F32, _F32,
                                          _F32, _INT, _PTR],
        "ota_round_stats_cols": [_PTR] * 16 + [_I64, _I64, _INT, _I64, _F32,
                                               _F32, _F32, _INT, _PTR],
        "ota_round_theta_cols": [_PTR] * 15 + [_I64, _I64, _INT, _I64, _F32,
                                               _F32, _F32, _INT, _PTR],
    },
    "admm_update": {
        "admm_dual_update": [_PTR] * 9 + [_I64, _I64, _F32, _PTR],
        "admm_flip_lambda": [_PTR] * 7 + [_I64, _I64, _F32, _PTR],
    },
    "phy_channel": {
        "fading_step": [_PTR] * 6 + [_I64, _F32, _F32, _INT, _PTR],
        "ota_receive_masked": [_PTR] * 8 + [_I64, _I64, _PTR],
    },
    "phy_population": {
        "population_step": [_PTR] * 20 + [_I64, _F32, _F32, _INT, _F32, _F32,
                                          _F32, _F32, _INT, _INT, _PTR],
    },
    "flash_attention": {
        "flash_attention_fwd": [_PTR] * 5 + [_I64] * 3 + [_INT, _INT, _F32,
                                                          _INT, _PTR],
        "flash_attention_dq": [_PTR] * 7 + [_I64] * 3 + [_INT, _INT, _F32,
                                                         _INT, _PTR],
        "flash_attention_dkv": [_PTR] * 8 + [_I64] * 3 + [_INT, _INT, _F32,
                                                          _INT, _PTR],
    },
    "linear_scan": {
        "linear_scan_fwd": [_PTR] * 3 + [_I64] * 3 + [_PTR],
        "linear_scan_bwd": [_PTR] * 5 + [_I64] * 3 + [_PTR],
        "linear_scan_fwd_staged": [_PTR] * 3 + [_I64] * 3 + [_INT] * 3
        + [_PTR],
        "linear_scan_bwd_staged": [_PTR] * 5 + [_I64] * 3 + [_INT] * 3
        + [_PTR],
    },
}

#: kernel launches per wrapper name since the last :func:`reset_launches`
launches: collections.Counter = collections.Counter()

_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


#: the dry run's hook around a plain version (``launch/trace_analysis``)
_PLAIN_HOOK: Dict[str, object] = {"hook": None}


def set_plain_hook(hook):
    """Make ``hook(name, fn, args, kwargs, flops, like)`` the one
    :func:`plain` calls (None: none); returns the previous hook."""
    prev = _PLAIN_HOOK["hook"]
    _PLAIN_HOOK["hook"] = hook
    return prev


def plain(name: str, fn, *args, flops: float = 0.0, like=None, **kwargs):
    """``fn(*args, **kwargs)``: wrapper ``name``'s plain version, on the
    tensors that do not launch the kernel.  Under the dry run's trace the
    call counts as the kernel would: its inputs read once, its outputs
    written once and ``flops`` (the kernel's products), not the plain
    version's own ops; ``like()``, where given, makes the outputs' ``meta``
    stand-ins without running a plain version that loops on the host."""
    hook = _PLAIN_HOOK["hook"]
    if hook is None:
        return fn(*args, **kwargs)
    return hook(name, fn, args, kwargs, flops, like)


def resolve_backend(device) -> str:
    """``"cuda"`` (the hand-written kernels) for CUDA tensors, ``"torch"``
    (the plain versions in ``kernels/ref.py``) for CPU tensors and for the
    dry run's ``meta`` tensors (shapes only, :func:`plain` counts them as
    the kernel); anything else fails fast."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda"
    if dev.type in ("cpu", "meta"):
        return "torch"
    raise ValueError(f"no OTA backend for device {dev}; the backends are "
                     f"{BACKENDS} for 'cpu' (or 'meta') and 'cuda' tensors")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); it is needed to "
                           "build the CUDA kernels")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes from ``csrc``, at any
    depth, in the order first reached."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    each, all started together.  Returns ``{name: {"seconds", "log",
    "cached"}}``; raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        path = library_path(name)
        if path.is_file():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (path, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log,
                     "cached": False}
        if proc.returncode != 0:
            failed.append(f"nvcc for {name}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check_cuda_f32(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every tensor is a contiguous float32 CUDA tensor on one device."""
    return check_cuda(name, (torch.float32,), **tensors)


def check_cuda(name: str, dtypes, **tensors: torch.Tensor) -> torch.device:
    """Every tensor is a contiguous CUDA tensor on one device, of a dtype in
    ``dtypes``."""
    device = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, want cuda")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the other "
                             f"operands on {device}")
        if t.dtype not in dtypes:
            want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous; pass "
                             f"x.contiguous()")
    return device


def launch(lib_name: str, fn_name: str, device: torch.device, *args,
           count: str = "") -> None:
    """Call C entry point ``fn_name`` on ``device``'s current PyTorch stream;
    raise if it reports a CUDA error, else count the launch under ``count``
    (the wrapper's name; ``fn_name`` by default)."""
    fn = getattr(library(lib_name), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with "
                           f"cudaError_t {err}")
    launches[count or fn_name] += 1
