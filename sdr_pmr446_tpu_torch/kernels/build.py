"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes``: one ``nvcc -c`` per source, all
started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -lineinfo -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libsdr_kernels_<hash>.so *.o

The library name carries a hash of the sources and flags, so a changed
source rebuilds at first use and an unchanged one is reused.  The build
goes to ``sdr_pmr446_tpu_torch/_build/`` (git-ignored); it needs the CUDA
toolkit and nothing else, and runs only when a CUDA tensor reaches a
kernel wrapper — importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from sdr_pmr446_tpu_torch.utils.profiling import count

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-lineinfo"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_LL = ctypes.c_longlong

#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so ctypes never truncates a 64-bit address)
SIGNATURES = {
    "duo_run": [
        _I, _P, _LL,                      # fmt, wire, n_samples
        _P, _P, _P, _I, _P, _P, _P,       # dc_x, dc_y, fhist, H, phist, parity, prev
        _P, _P, _P, _P, _P,               # kt, pg, pc, pw, pj
        _D, _D, _D, _F, _F,               # p, g, pL, inv_cu8, dscale
        _I, _I,                           # K, ns
        _P, _P, _P, _P, _P,               # ylocal, yend, carry, band, chan
        _P, _P, _P, _P, _P, _P, _P,       # outputs
        _P,                               # stream
    ],
    "mono_run": [
        _I, _I, _P, _LL,                  # fmt, mode, wire, n_samples
        _P, _P, _P, _I, _P, _I,           # dc_x, dc_y, fhist, H, bhist, HB
        _P, _P, _I, _P,                   # sig_prev, dhist, DH, n0
        _P, _P, _D, _D, _D, _F,           # kt, pj, p, g, pL, inv_cu8
        _P, _I, _P, _P, _I, _F,           # kd, J, tab, post taps, width, dscale
        _P, _P, _P, _P, _P,               # ylocal, yend, carry, band, dem
        _P, _P, _P, _P, _P, _P, _P, _P,   # outputs
        _P,                               # stream
    ],
    "fe_run": [
        _I, _P, _LL,                      # fmt, wire, n_samples
        _P, _P, _P, _I,                   # dc_x, dc_y, fhist, H
        _P, _P, _D, _D, _D, _F,           # kt, pj, p, g, pL, inv_cu8
        _P, _P, _P, _P,                   # ylocal, yend, carry, band
        _P, _P, _P,                       # dc_x, dc_y, fhist outputs
        _P,                               # stream
    ],
    "pfb_demod_run": [
        _P, _LL, _P, _P, _P,              # band, nb, phist, parity, prev
        _P, _P, _P, _F, _I, _I,           # pg, pc, pw, dscale, K, ns
        _P, _P, _P, _P, _P,               # chan, phist', demod, mag, prev'
        _P,                               # stream
    ],
    "resample_run": [
        _P, _I, _P, _P, _LL, _P,          # hist, P - 1, xr, xi, n, kt
        _P, _P,                           # band, hist'
        _P,                               # stream
    ],
    "tail_run": [
        _I, _P, _LL, _P, _I,              # mode, band, nb, bhist, HB
        _P, _P, _I, _P,                   # sig_prev, dhist, DH, n0
        _P, _I, _P, _P, _I, _F,           # kd, J, tab, post taps, width, dscale
        _P,                               # dem
        _P, _P, _P, _P, _P,               # bhist', sig_prev', dhist', n0', out
        _P,                               # stream
    ],
    "audio_bank_run": [
        _P, _I, _P, _I,                   # demod, F, hist, H
        _P, _P, _P, _P, _P, _I, _I,       # dc_x, dc_y, gain, b_arr, sel, K, ns
        _P, _I, _I,                       # staged taps, La, Ll
        _P, _D, _D, _D, _P,               # pj, p, g, pL, f10
        _P, _P, _P, _P,                   # lp_last, lplocal, yend, carry
        _P, _P, _P, _P, _P, _P,           # outputs
        _P,                               # stream
    ],
    "audio_bank_apply": [
        _P, _I, _P, _I, _P,               # demod, F, hist, H, gain
        _P, _I, _I,                       # staged taps, La, Ll
        _P, _P, _P,                       # lp, audio, hist'
        _P,                               # stream
    ],
    "audio_bank_apply_dc": [
        _P, _I, _P, _I,                   # demod, F, hist, H
        _P, _P, _P,                       # dc_x, dc_y, gain
        _P, _I, _I,                       # staged taps, La, Ll
        _P, _D, _D, _D,                   # pj, p, g, pL
        _P, _P, _P, _P,                   # lp_last, lplocal, yend, carry
        _P, _P, _P, _P, _P,               # audio, hist', dc_x', dc_y', lp_dcb
        _P,                               # stream
    ],
    "wf_run": [
        _P, _LL, _P, _I, _P,              # band, nb, hist, hist_len, cnt
        _P, _P, _P,                       # pre, filt (or None), tw
        _I, _I, _I, _I, _I, _I,           # w, K, sub, M, M1, nt
        _I, _I,                           # slab_hops, slabs
        _P, _P,                           # scratch, part
        _P, _P, _P,                       # rows, hist_out, cnt_out
        _P,                               # stream
    ],
    "wf_blocks_per_sm": [
        _I, _I, _I, ctypes.POINTER(_I),   # w, M, nt, blocks out
    ],
    "zero_summary_run": [
        _I, _P, _LL, _P, _F,              # fmt, wire, n_samples, v, inv_cu8
        _P, _P,                           # w, xl
        _P,                               # stream
    ],
    "ring_shift_run": [
        _P, _P, _I, _I, _LL,              # src, dst, n_stream, n_time, bytes
        _LL, _LL, _LL, _LL,               # src / dst stream and shard strides
        _P,                               # stream
    ],
    "shard_hist_planes_run": [
        _P, _LL, _LL, _LL,                # re tail, im offset, strides
        _P, _LL,                          # carried, its stream stride
        _P, _LL, _LL,                     # hist, its stream / shard strides
        _P, _LL,                          # new_carried, its stream stride
        _I, _I, _I,                       # n_stream, n_time, h
        _P,                               # stream
    ],
    "probe_dot_run": [
        _P, _P, _P, _I, _I, _I, _I,       # a, b, out, M, N, K, mode
        _P,                               # stream
    ],
    "probe_layout_run": [
        _I, _P, _P,                       # move, x, out
        _P,                               # stream
    ],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run(procs) -> list[str]:
    """Wait for every (cmd, Popen), then raise on the first that failed."""
    done = [(cmd, *proc.communicate(), proc.returncode)
            for cmd, proc in procs]
    for cmd, out, err, code in done:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                               f"{out}\n{err}")
    return [err for _, _, err, _ in done]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists.

    Returns the library path.  Every source compiles in its own ``nvcc``
    process, all at once; the link writes to a temporary name that is renamed
    into place, so a concurrent build never loads a partial file.
    """
    lib = BUILD_DIR / f"libsdr_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = str(Path(tmp_dir) / (src.stem + ".o"))
            cmd = ([nvcc] + COMPILE_FLAGS
                   + (["-Xptxas", "-v"] if verbose else [])
                   + ["-c", str(src), "-o", obj])
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = _run(procs)
        tmp = str(Path(tmp_dir) / "lib.so")
        cmd = [nvcc] + LINK_FLAGS + ["-o", tmp] + objs
        logs += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, lib)
    if verbose:
        print(f"built {lib} in {time.perf_counter() - t0:.1f} s\n"
              + "".join(logs))
    return lib


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled function name: its SASS}."""
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m[1]
            out[name] = ""
        elif name is not None:
            out[name] += line + "\n"
    return out


def sass_by_function(lib: Path | None = None) -> dict:
    """The SASS of each function in the built library, read by the
    toolkit's cuobjdump beside nvcc (parse_sass)."""
    lib = build() if lib is None else lib
    tool = Path(nvcc_path()).with_name("cuobjdump")
    return parse_sass(subprocess.run(
        [str(tool), "-sass", str(lib)], capture_output=True, text=True,
        check=True, timeout=300).stdout)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call), argtypes set;
    each load counts ``kernels.library_loads``."""
    lib = ctypes.CDLL(str(build()))
    count("kernels.library_loads")
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sdr_error_string.argtypes = [ctypes.c_int]
    lib.sdr_error_string.restype = ctypes.c_char_p
    return lib


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on ``device``
    (and of ``shape`` unless that is None) — checked before any pointer
    reaches a kernel."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_aligned(addr: int, name: str) -> None:
    """Raise unless the device address ``addr`` starts on 16 bytes: the
    kernels that load or copy 16 B at a time refuse anything else."""
    if addr % 16:
        raise ValueError(f"{name}: address {addr:#x} is not 16-byte aligned")


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().sdr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous and alone in its storage, else a copy that
    is: a custom op's output may not be a view (of an input, of another
    output, or at an offset in a larger buffer)."""
    if (t.is_contiguous() and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.numel() * t.element_size()):
        return t
    return t.clone(memory_format=torch.contiguous_format)
