"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, into ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``); the library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded. Each source carries its own extra flags
(``SOURCE_FLAGS``): the kernels held bit-equal to their plain versions are
built with ``-fmad=false``, so that no multiply-add is contracted. Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# source -> flags added to NVCC_FLAGS for it
SOURCE_FLAGS = {
    "guided_score_tile.cu": ("-fmad=false",),
    "embedding_bag.cu": ("-fmad=false",),
    "flash_attention_mma.cu": (),
    "flash_attention_split.cu": (),
    "flash_attention_f32.cu": (),
}
SOURCES = tuple(SOURCE_FLAGS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# offs, wb, wl, essential, prefix_beta, skip, th_lo, alpha, beta, gamma,
# out, B, C, Nq, P, tile_size, block_s, stream
_GUIDED_ARGS = [_P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _P,
                _I, _I, _I, _I, _I, _I, _P]
# words, qb_row, ql_row, meta_i, meta_f, qw_b, qw_l, essential,
# prefix_beta, skip, th_lo, alpha, beta, gamma, out, B, C, Nq, Wp, P,
# tile_size, block_s, stream
_GUIDED_Q_ARGS = [_P] * 11 + [_F, _F, _F, _P] + [_I] * 7 + [_P]
_L = ctypes.c_longlong
SIGNATURES = {
    "guided_score_tile.cu": {
        "guided_score_tile_launch": _GUIDED_ARGS,
        "guided_score_chunk_launch": _GUIDED_ARGS,
        "guided_score_tile_q_launch": _GUIDED_Q_ARGS,
        "guided_score_chunk_q_launch": _GUIDED_Q_ARGS,
        "error_string": [_I],
    },
    # table, idx, w, out, dtype, n_bags, n_fields, bag_len, vocab, d, stream
    "embedding_bag.cu": {
        "embedding_bag_launch": [_P, _P, _P, _P, _I, _L, _I, _I, _L, _I, _P],
    },
    # q, k, v, o, batch, h, hkv, sq, skv, d, 12 strides (q, k, v, o: batch,
    # head, position), causal, kv_offset, sm_scale, stream (bfloat16 only)
    "flash_attention_mma.cu": {
        "flash_attention_mma_launch": [_P] * 4 + [_I] * 6 + [_L] * 12
                                      + [_I, _I, _F, _P],
    },
    # the same (float32 only)
    "flash_attention_f32.cu": {
        "flash_attention_f32_launch": [_P] * 4 + [_I] * 6 + [_L] * 12
                                      + [_I, _I, _F, _P],
    },
    # q, k, v, o, scratch, the mma arguments, n_split, split_keys, stream
    "flash_attention_split.cu": {
        "flash_attention_split_launch": [_P] * 5 + [_I] * 6 + [_L] * 12
                                        + [_I, _I, _F, _I, _I, _P],
    },
}
_RESTYPES = {"error_string": ctypes.c_char_p}

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}     # source -> {"seconds", "path", "ptxas"}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def flags(source: str) -> tuple[str, ...]:
    """The nvcc flags ``source`` is built with."""
    return NVCC_FLAGS + SOURCE_FLAGS[source]


def _lib_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(flags(source)).encode()
                            ).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}_{digest[:16]}.so"


def _compile(source: str) -> Path:
    out = _lib_path(source)
    if out.exists():
        build_log[source] = {"seconds": 0.0, "path": str(out), "ptxas": ""}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags(source), "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)     # atomic: a reader never sees a partial library
    build_log[source] = {"seconds": time.perf_counter() - t0,
                         "path": str(out), "ptxas": proc.stderr.strip()}
    return out


def build_all() -> dict:
    """Compile every source (one ``nvcc`` each, all started together) and
    load the libraries. Returns ``build_log``."""
    todo = [s for s in SOURCES if s not in _libs]
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        paths = list(pool.map(_compile, todo))
    for source, path in zip(todo, paths):
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _libs[source] = lib
    return build_log


def load(source: str = "guided_score_tile.cu") -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use."""
    if source not in _libs:
        build_all()
    return _libs[source]


def error_string(code: int) -> str:
    """The CUDA runtime's name for an error code a launcher returned."""
    return load().error_string(code).decode()


def launch(source: str, fn_name: str, device: torch.device, *args) -> None:
    """Call launcher ``fn_name`` of ``source``'s library with ``args`` (ints,
    floats and tensors, which pass as their data pointers) and the current
    stream of ``device``. Raises when it returns a CUDA error."""
    lib = load(source)
    ptr = ctypes.c_void_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            *(ptr(a.data_ptr()) if isinstance(a, torch.Tensor) else a
              for a in args), ptr(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {error_string(rc)} "
                           f"(cudaError {rc})")
