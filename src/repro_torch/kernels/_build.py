"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library at first use, under ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header rebuilds.  Importing this
module needs no ``nvcc``: nothing is compiled until a kernel is first
launched.  ``build_all`` compiles every source at once,
one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# argtypes of every C entry point, by source: each pointer and the stream
# are c_void_p (a bare Python int would be cut to 32 bits), sizes c_int
_P, _I = ctypes.c_void_p, ctypes.c_int
_LINEAR = [_P] * 10 + [_I] * 5 + [_P]
_LINEAR_BF16 = [_P] * 12 + [_I] * 5 + [_P]      # + env16, planes
_BORN = [_P] * 8 + [_I] * 5 + [_P]
_CONTRACT_MEASURE = [_P] * 5 + [_I] * 4 + [_P]
_CONTRACT_MEASURE_BF16 = [_P] * 7 + [_I] * 4 + [_P]   # + env16, gamma16
_MEASURE = [_P] * 3 + [_I] * 3 + [_P]
_COLLAPSE = [_P] * 6 + [_I] * 4 + [_P]
_COLLAPSE_BF16 = [_P] * 8 + [_I] * 4 + [_P]      # + env16, planes
_DISPLACEMENT = [_P] * 6 + [_I] * 2 + [_P]
_DISPLACEMENT_COMPLEX = [_P] * 4 + [_I] * 2 + [_P]
_FLASH = [_P] * 4 + [_I] * 7 + [_P]
SIGNATURES = {
    "site_step": {
        "fastmps_max_d": [],
        "fastmps_site_step_linear_f64": _LINEAR,
        "fastmps_site_step_linear_f32": _LINEAR,
        "fastmps_site_step_born_c128": _BORN,
        "fastmps_site_step_born_c64": _BORN,
        "fastmps_contract_measure_f64": _CONTRACT_MEASURE,
        "fastmps_contract_measure_f32": _CONTRACT_MEASURE,
        "fastmps_measure_probs_f64": _MEASURE,
        "fastmps_measure_probs_f32": _MEASURE,
        "fastmps_collapse_select_f64": _COLLAPSE,
        "fastmps_collapse_select_f32": _COLLAPSE,
        "fastmps_site_step_linear_bf16_f32_f32": _LINEAR_BF16,
        "fastmps_site_step_linear_bf16_f32_bf16": _LINEAR_BF16,
        "fastmps_site_step_linear_bf16_f64_f64": _LINEAR_BF16,
        "fastmps_contract_measure_bf16_f32_f32": _CONTRACT_MEASURE_BF16,
        "fastmps_contract_measure_bf16_f32_bf16": _CONTRACT_MEASURE_BF16,
        "fastmps_contract_measure_bf16_f64_f64": _CONTRACT_MEASURE_BF16,
        "fastmps_measure_probs_bf16_f32": _MEASURE,
        "fastmps_measure_probs_bf16_f64": _MEASURE,
        "fastmps_collapse_select_bf16_f32_f32": _COLLAPSE_BF16,
        "fastmps_collapse_select_bf16_f32_bf16": _COLLAPSE_BF16,
        "fastmps_collapse_select_bf16_f64_f64": _COLLAPSE_BF16,
    },
    "displacement_expm": {
        "fastmps_displacement_expm_f64": _DISPLACEMENT,
        "fastmps_displacement_expm_f32": _DISPLACEMENT,
        "fastmps_displacement_expm_c128": _DISPLACEMENT_COMPLEX,
        "fastmps_displacement_expm_c64": _DISPLACEMENT_COMPLEX,
    },
    "flash_attention": {
        "fastmps_flash_attention_bf16": _FLASH,
        "fastmps_flash_attention_f32": _FLASH,
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds: dict[str, float] = {}     # wall time of each build, if built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, target, tmp) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp


def _finish(name: str, started, t0: float) -> None:
    proc, target, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    (BUILD_DIR / f"{target.stem}.log").write_text(log)
    os.replace(tmp, target)            # atomic: concurrent builds agree
    build_seconds[name] = time.perf_counter() - t0


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source not yet built (in parallel) and load them all."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in SIGNATURES if n not in _libs}
        errors = []
        for n, s in started.items():       # reap every nvcc before raising
            if s is not None:
                try:
                    _finish(n, s, t0)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in started:
            _libs[n] = _load(n)
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when the library was built here."""
    log = BUILD_DIR / f"{_target(name).stem}.log"
    return log.read_text() if log.exists() else ""


def ptxas_kernels(log: str) -> dict[str, dict]:
    """Per kernel function in a ``-Xptxas -v`` log: its registers and spill
    bytes, keyed by a short name (``flash_tc_kernel<64>``: the function's
    name and its integer template arguments, from the mangled name)."""
    out: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(_Z\w+)", line)
        if m:
            current = out.setdefault(_short_name(m.group(1)), {})
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def _short_name(mangled: str) -> str:
    """The last length-prefixed identifier of an Itanium-mangled name, with
    the integer values of the template arguments that follow it."""
    i, name, rest = mangled.find("N") + 1, mangled, ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        rest = mangled[i:]
    args = re.findall(r"L[ib](\d+)E", rest.split("Ev")[0]) if rest[:1] == "I" \
        else []
    return name + (f"<{', '.join(args)}>" if args else "")


_count_lock = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    """Add one launch to ``counts[name]`` (a wrapper's ``LAUNCHES``): the
    service's thread lanes launch from several threads at once."""
    with _count_lock:
        counts[name] += 1


def check_operands(name: str, device: torch.device, operands: dict) -> None:
    """Raise unless every ``operands[arg] = (tensor, dtype)`` lies on
    ``device``, has that dtype and is contiguous."""
    for arg, (t, dt) in operands.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_sizes(name: str, d: int, *sizes: int) -> None:
    """Raise unless ``d`` is within the kernels' ``MAX_D`` and every size is
    positive and fits their 32-bit indices."""
    max_d = library("site_step").fastmps_max_d()
    if not 1 <= d <= max_d:
        raise ValueError(f"{name}: d={d} outside the kernel's 1..{max_d}")
    if min(sizes) < 1:
        raise ValueError(f"{name}: empty operand")
    if max(sizes) >= 2 ** 31:
        raise ValueError(f"{name}: sizes exceed the kernel's 32-bit indices")


def launch(entry: str, tensors, ints, device: torch.device, name: str,
           source: str = "site_step") -> None:
    """Call one C entry of ``csrc/<source>.cu`` on the current stream of
    ``device``: the tensors' pointers (None: a null pointer), then the ints,
    then the stream.  Raises if the entry returns a CUDA error (a refused
    launch)."""
    fn = getattr(library(source), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(ctypes.c_void_p(None if t is None else t.data_ptr())
                   for t in tensors),
                 *(int(i) for i in ints), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
