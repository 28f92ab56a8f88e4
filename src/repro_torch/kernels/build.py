"""Build and load the CUDA kernels of this package.

The sources under ``csrc/`` have a plain C interface and include nothing of
PyTorch. At first use every ``*.cu`` file is compiled for ``sm_90a`` to an
object file (one ``nvcc`` process per source, all started together; a
kernel with many instantiations spreads them over files that include its
``*.cuh``), the objects are linked into one shared library, and the library
is loaded with :mod:`ctypes`. The library's name carries a hash of the
sources, their headers and the flags, so an edited source is rebuilt and a
stale library is never loaded.

The build directory is ``build/`` at the root of the checkout (or
``$REPRO_TORCH_BUILD_DIR``). A failed build raises; nothing here falls back
to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
#: seconds nvcc took when this process built the library (0.0 if it never
#: had to: the library was already there)
build_seconds: float = 0.0


class KernelCompileError(RuntimeError):
    """nvcc is missing, or it refused a source."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels of repro_torch cannot be built "
        "on this host")


def _digest(srcs: List[Path], flags: Sequence[str] = ()) -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + list(flags)).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library_path(csrc: Optional[Path] = None,
                 bdir: Optional[Path] = None,
                 flags: Sequence[str] = ()) -> Path:
    csrc = CSRC if csrc is None else Path(csrc)
    files = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    return (build_dir() if bdir is None else Path(bdir)) / (
        f"librepro_torch_kernels_{_digest(files, flags)}.so")


def build(csrc: Optional[Path] = None, bdir: Optional[Path] = None,
          flags: Sequence[str] = ()) -> Path:
    """Compile and link the kernels if their library is not there yet;
    returns the library's path. ``csrc`` and ``bdir`` default to this
    package's sources and :func:`build_dir`; another pair builds another
    copy of the sources (an earlier commit's, to time beside these) into
    its own directory, with its own ``build.log``. ``flags`` are added to
    every ``nvcc`` of the sources (``-DREPRO_FLASH_PHASES``: the chunked
    flash kernel's phase probes)."""
    global build_seconds
    csrc = CSRC if csrc is None else Path(csrc)
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise KernelCompileError(f"no CUDA sources under {csrc}")
    out = library_path(csrc, bdir, flags)
    if out.exists():
        return out
    nvcc = find_nvcc()
    bdir = build_dir() if bdir is None else Path(bdir)
    bdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = out.stem.rsplit("_", 1)[-1]
    objs = [bdir / f"{s.stem}_{tag}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *flags, "-c", str(s), "-o",
         str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    log, failed = [], []
    for s, p in zip(srcs, procs):
        text, _ = p.communicate()
        log.append(f"== nvcc {s.name} (exit {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(s.name)
    (bdir / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelCompileError(
            f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelCompileError(f"linking {out.name} failed:\n{link.stdout}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def build_probe(src: Path) -> Path:
    """Compile one stand-alone source (a measurement probe kept outside
    ``csrc/``) with the kernels' flags into its own shared library in the
    build directory; returns its path. Rebuilt only when the source or the
    flags change. What ``nvcc -Xptxas -v`` said is kept beside it, in a
    ``.log`` of the same name."""
    out = build_dir() / f"lib{src.stem}_{_digest([src])}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run(
        [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if run.returncode != 0:
        raise KernelCompileError(f"nvcc failed on {src.name}:\n{run.stdout}")
    out.with_suffix(".log").write_text(run.stdout)
    os.replace(tmp, out)
    return out


def build_log(bdir: Optional[Path] = None) -> str:
    """What ``nvcc -Xptxas -v`` said in the last build into ``bdir``
    (:func:`build_dir` by default): registers, shared memory and spills of
    every kernel."""
    path = (build_dir() if bdir is None else Path(bdir)) / "build.log"
    return path.read_text() if path.exists() else ""


def bind(path: Path) -> ctypes.CDLL:
    """Load a kernels' library and set the argument types of every exported
    function: a pointer or a stream passed without them would be cut to 32
    bits."""
    lib = ctypes.CDLL(str(path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_vai_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
    lib.repro_vai_f32.restype = i32
    lib.repro_membw_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64,
                                    i64, ptr]
    lib.repro_membw_f32.restype = i32
    lib.repro_flash_attention.argtypes = (
        [i32, ptr, ptr, ptr, ptr] + [i32] * 7 + [i64] * 12
        + [i32, ctypes.c_float, i32, i32, ptr])
    lib.repro_flash_attention.restype = i32
    lib.repro_error_string.argtypes = [i32]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use (:func:`bind`)."""
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def check_launch(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")


#: ``cuobjdump -sass`` of each library disassembled so far, keyed by its
#: path and modification time: one disassembly serves every query
_disassembly: dict = {}


def sass(function_substring: str, library: Optional[Path] = None) -> str:
    """Disassembly (``cuobjdump -sass``) of the kernels whose name contains
    ``function_substring`` — to check what the compiler made of a loop.
    ``library`` is the kernels' library by default, or a probe's."""
    lib = build() if library is None else library
    key = (str(lib), Path(lib).stat().st_mtime_ns)
    if key not in _disassembly:
        tool = shutil.which("cuobjdump") or str(
            Path(find_nvcc()).parent / "cuobjdump")
        _disassembly[key] = subprocess.run(
            [tool, "-sass", str(lib)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, check=True).stdout
    chunks = _disassembly[key].split("\t\tFunction : ")
    return "\n".join("Function : " + c for c in chunks[1:]
                     if function_substring in c.split("\n", 1)[0])


_OPCODE = re.compile(r"^\s*(?:/\*[0-9a-f]+\*/)?\s*(?:@!?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s+([^;]*);")
_REGISTER = re.compile(r"-?\|?R(\d+)\|?(\.reuse)?")


def ffma_bank_counts(sass_text: str) -> dict:
    """What the fp32 FMAs of a SASS listing read: ``ffma`` FFMAs in all,
    ``same_bank`` of them whose three distinct source registers have one
    index parity (one bank of the register file, if it has two banks by
    parity as the microbenchmark studies of Volta and Turing found),
    ``reuse`` of them with a source marked ``.reuse`` (kept in the operand
    reuse cache for the next instruction), and ``fmul`` / ``fadd``: a chain
    of FMAs folded by the compiler would show as these. Constants,
    immediates, ``RZ`` and uniform registers are not register-file
    reads."""
    counts = dict(ffma=0, same_bank=0, reuse=0, fmul=0, fadd=0)
    for line in sass_text.splitlines():
        m = _OPCODE.match(line)
        if m is None:
            continue
        op = m.group(1)
        if op in ("FMUL", "FADD"):
            counts[op.lower()] += 1
        if op != "FFMA":
            continue
        counts["ffma"] += 1
        sources = [o.strip() for o in m.group(3).split(",")][1:4]
        regs = [_REGISTER.fullmatch(o) for o in sources]
        if any(r and r.group(2) for r in regs):
            counts["reuse"] += 1
        distinct = {int(r.group(1)) for r in regs if r}
        if (len(distinct) == 3 and all(r for r in regs)
                and len({i % 2 for i in distinct}) == 1):
            counts["same_bank"] += 1
    return counts
