"""Build and load the port's CUDA kernels (rrrmc_tpu_torch/csrc/*.cu).

At first use, `nvcc` compiles every source into one shared library with a
plain C interface, for the H100 (`sm_90a`), into rrrmc_tpu_torch/_build/: one
`nvcc -c` per source, all started together, then one link. The library is
named by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses it. It is loaded with ctypes, every pointer and
the stream passed as c_void_p. A missing nvcc or a failed build raises; there
is no fallback.

Flags: no --use_fast_math (expf/logf stay at full precision), and
-fmad=false, so that no a*b+c is contracted into an FMA and the kernels round
exactly as their plain torch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P, _I, _U, _F, _Z = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float, ctypes.c_size_t)
#: C signatures of the library's functions: (restype, argtypes)
_SIGNATURES = {
    "rrrmc_site_metropolis": (_I, [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                                   _P, _U, _U, _U, _P, _I, _I, _P, _P]),
    "rrrmc_site_cut": (_I, [_P, _I, _P, _I, _I, _I, _P, _P]),
    "rrrmc_site_info": (_I, [_I, _I, _Z, _I, _P]),
    "rrrmc_rejfree_sparse": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _U, _U, _U, _F, _I, _F,
                                  _I, _I, _I, _I, _P]),
    "rrrmc_rejfree_sparse_smem": (_Z, [_I, _I, _I]),
    "rrrmc_rejfree_sparse_info": (_I, [_I, _I, _I, _Z, _I, _P]),
    "rrrmc_rejfree_classes": (_I, [_P] * 10 + [_I] * 5 + [_U, _U, _U, _F,
                                                         _I, _P]),
    "rrrmc_rejfree_classes_smem": (_Z, [_I, _I]),
    "rrrmc_rejfree_classes_info": (_I, [_Z, _I, _P]),
    "rrrmc_sweep": (_I, [_P] * 5 + [_I] * 8 + [_U, _U, _U, _F, _P]),
    "rrrmc_sweep_info": (_I, [_I, _I, _I, _I, _Z, _I, _P]),
    "rrrmc_sk_sweep": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _U,
                            _I, _I, _P]),
    "rrrmc_sk_smem": (_Z, [_I, _I]),
    "rrrmc_sk_max_smem": (_I, [_I]),
    "rrrmc_sk_info": (_I, [_I, _I, _I, _P]),
    "rrrmc_rejfree_dense": (_I, [_P] * 10 + [_I, _I, _I, _U, _U, _U, _F,
                                             _I, _F, _I, _I, _I, _I, _I,
                                             _P]),
    "rrrmc_rejfree_dense_smem": (_Z, [_I, _I, _I, _I]),
    "rrrmc_rejfree_dense_info": (_I, [_I, _I, _I, _Z, _I, _P]),
    "rrrmc_eo_sparse": (_I, [_P] * 9 + [_I] * 4 + [_U] * 3 + [_I] * 3
                        + [_F, _F, _I, _P]),
    "rrrmc_eo_sparse_smem": (_Z, [_I, _I, _I, _I]),
    "rrrmc_eo_sparse_info": (_I, [_I, _I, _I, _Z, _I, _P]),
    "rrrmc_eo_dense": (_I, [_P] * 8 + [_I, _I, _I, _U, _U, _U, _I, _I, _F,
                                       _F, _I, _P]),
    "rrrmc_eo_dense_smem": (_Z, [_I, _I, _I, _I]),
    "rrrmc_eo_dense_info": (_I, [_I, _I, _Z, _I, _P]),
    "rrrmc_rejfree_sat": (_I, [_P] * 12 + [_I] * 6 + [_U, _U, _U, _F, _I,
                                                     _F, _I, _I, _P]),
    "rrrmc_rejfree_sat_smem": (_Z, [_I, _I, _I]),
    "rrrmc_rejfree_sat_info": (_I, [_I, _I, _Z, _I, _P]),
    "rrrmc_eo_sat": (_I, [_P] * 11 + [_I] * 6 + [_U, _U, _U, _I, _I, _I,
                                                  _P]),
    "rrrmc_eo_sat_smem": (_Z, [_I] * 5),
    "rrrmc_eo_sat_info": (_I, [_I, _I, _Z, _I, _P]),
    "rrrmc_rejfree_replica": (_I, [_P] * 11 + [_I] * 5 + [_U, _U, _U, _F,
                                                          _I, _F, _I, _I, _I,
                                                          _I, _I, _P]),
    "rrrmc_rejfree_replica_smem": (_Z, [_I] * 6),
    "rrrmc_rejfree_replica_info": (_I, [_I, _I, _I, _I, _Z, _I, _P]),
    "rrrmc_replica_sweep": (_I, [_P] * 6 + [_I] * 4 + [_F, _U, _U, _U, _I,
                                                        _I, _I, _P]),
    "rrrmc_replica_sweep_smem": (_Z, [_I, _I]),
    "rrrmc_replica_sweep_max_smem": (_I, [_I]),
    "rrrmc_replica_sweep_info": (_I, [_I, _I, _I, _I, _P]),
    "rrrmc_rejfree_perc": (_I, [_P] * 9 + [_I] * 4 + [_U, _U, _U, _F, _I,
                                                      _F, _I, _I, _F, _I, _I,
                                                      _I, _P]),
    "rrrmc_rejfree_perc_smem": (_Z, [_I, _I, _I, _I, _I]),
    "rrrmc_rejfree_perc_info": (_I, [_I, _I, _I, _I, _Z, _I, _P]),
    "rrrmc_eo_perc": (_I, [_P] * 8 + [_I] * 4 + [_U, _U, _U, _I, _I, _F,
                                                  _I, _P]),
    "rrrmc_eo_perc_smem": (_Z, [_I, _I, _I, _I, _I]),
    "rrrmc_eo_perc_info": (_I, [_I, _I, _I, _I, _Z, _I, _P]),
}

_lib = None
#: the library's path, and what its build printed (the ptxas register and
#: shared-memory report; empty when the library was already built)
build_info = {"log": "", "path": ""}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "rrrmc_tpu_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librrrmc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    so = library_path()
    build_info["path"] = str(so)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cu, objs)]
        logs = []
        try:
            for p, proc in zip(cu, procs):
                out, _ = proc.communicate(timeout=900)
                logs.append(f"{p.name}:\n{out}")
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {p.name} "
                                       f"({proc.returncode}):\n{out}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, so.name)
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True, timeout=900)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib, so)
    build_info["log"] = "\n".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
