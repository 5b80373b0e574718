"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` call per source builds a shared library in seconds.  Libraries
land in ``build/repro_torch_kernels/`` at the root of the checkout the
package runs from (``resolve_build_dir``), named by a hash of the source
and of the headers it includes (``source_files``), so an edited source
or header is never served a stale build; the compiler's
``-Xptxas -v`` report is kept beside each library (``ptxas_report``), and
``ptxas_usage``, ``sass_counts`` and ``kernel_label`` read registers,
spills and instruction counts per kernel out of such reports.  A missing
``nvcc`` or a failed build raises with the compiler's output; nothing
here falls back to a plain version.  ``use_cuda_for`` is the ops
modules' one dispatch rule between a kernel and its plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "SOURCES", "resolve_build_dir", "find_nvcc",
           "nvcc_command", "build_all", "load", "launch", "use_cuda_for",
           "source_files", "library_path", "ptxas_report", "ptxas_usage",
           "sass_counts", "kernel_label"]

_PKG = Path(__file__).resolve().parent
BUILD_ENV = "REPRO_TORCH_BUILD_DIR"


def resolve_build_dir(pkg: Path = _PKG, environ=os.environ) -> Path:
    """Where the libraries are built.

    From a checkout (the package lies under ``<root>/src`` and ``<root>``
    holds ``pyproject.toml``): ``<root>/build/repro_torch_kernels``.  An
    installed package builds where ``$REPRO_TORCH_BUILD_DIR`` says, else
    in ``~/.cache/repro_torch_kernels``.
    """
    for root in pkg.parents:
        if (root / "pyproject.toml").is_file() and pkg.is_relative_to(
                root / "src"):
            return root / "build" / "repro_torch_kernels"
    if environ.get(BUILD_ENV):
        return Path(environ[BUILD_ENV])
    return Path.home() / ".cache" / "repro_torch_kernels"


BUILD_DIR = resolve_build_dir()
SOURCES = {
    "gwf_waterfill": _PKG / "gwf_waterfill" / "csrc" / "gwf_waterfill.cu",
    "flash_attention": (_PKG / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    "flash_attention_bwd": (_PKG / "flash_attention" / "csrc"
                            / "flash_attention_bwd.cu"),
    "linear_scan": _PKG / "linear_scan" / "csrc" / "linear_scan.cu",
}
DEFAULT_CUDA_HOME = "/usr/local/cuda"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME or the default toolkit dir."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in "
        f"{DEFAULT_CUDA_HOME}/bin; the CUDA kernels cannot be built")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """Source ``name`` and, in the order they are first met, the headers
    it includes with quotes, each found beside the file that includes
    it, and theirs in turn."""
    files, todo = [], [SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())]
    return files


def library_path(name: str) -> Path:
    """The shared library built from source ``name``, named by a hash of
    the source and its headers (it may not exist yet)."""
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) from building source
    ``name``, kept beside the library; empty if it was never built."""
    path = library_path(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


_PTXAS_FN = re.compile(r"(?:Compiling entry function|Function properties "
                       r"for) '?([\w$.]+)'?")
_PTXAS_NUM = {"registers": re.compile(r"Used (\d+) registers"),
              "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
              "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
              "spill_load_bytes": re.compile(r"(\d+) bytes spill loads")}


def ptxas_usage(report: str) -> dict[str, dict[str, int]]:
    """Registers, stack and spill bytes per kernel (mangled name) from a
    ptxas ``-v`` report."""
    usage: dict[str, dict[str, int]] = {}
    fn = None
    for line in report.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
            continue
        if fn is None:
            continue
        for key, pat in _PTXAS_NUM.items():
            m = pat.search(line)
            if m:
                usage[fn][key] = int(m.group(1))
    return usage


def kernel_label(mangled: str) -> str:
    """A short name of a kernel instantiation from its mangled name:
    ``flash_attention_kernel<bf16,256>``, ``linear_scan_kernel<f32>``,
    ``hetero_waterfill_kernel<256>``, ``gwf_waterfill_kernel``."""
    m = re.search(r"([a-z][a-z_]*_kernel)(?:I(13__nv_bfloat16|f)?"
                  r"(?:Li(\d+)E)?E)?", mangled)
    if m is None:
        return mangled
    name, ty, hd = m.groups()
    args = ",".join(x for x in ({"13__nv_bfloat16": "bf16",
                                 "f": "f32"}.get(ty), hd) if x)
    return f"{name}<{args}>" if args else name


def sass_counts(sass: str, opcodes) -> dict[str, dict[str, int]]:
    """Per function of ``cuobjdump -sass`` output, how many instructions
    start with each of ``opcodes`` (``HMMA`` counts ``HMMA.16816.F32``)."""
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(opcodes, 0)
            continue
        if fn is None:
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if m and m.group(1) in counts[fn]:
            counts[fn][m.group(1)] += 1
    return counts


def nvcc_command(name: str, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that builds source ``name``."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(library_path(name)), str(SOURCES[name])]


def build_all(names=None) -> dict[str, str]:
    """Build every missing library, one nvcc per source, all at once.

    Returns the compiler's ptxas report per source built (empty when all
    were built already).  Raises RuntimeError with the compiler output
    when a build fails.
    """
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(nvcc_command(n, nvcc), stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n in todo}
    reports, failed = {}, []
    for n, p in procs.items():
        out, _ = p.communicate()
        reports[n] = out
        if p.returncode == 0:
            library_path(n).with_suffix(".ptxas.txt").write_text(out)
        else:
            failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n{out}")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def launch(name: str, fn: str, argtypes, device, *args) -> None:
    """Call C entry point ``fn`` of source ``name`` with ``args`` and the
    current stream of ``device``; raise if it returns a CUDA error.

    Every pointer, and the stream, goes as ``c_void_p`` (a bare int would
    be cut to 32 bits); ``argtypes`` lists the arguments before the
    stream.
    """
    entry = _ENTRIES.get((name, fn))
    if entry is None:
        entry = getattr(load(name), fn)
        entry.argtypes = [*argtypes, ctypes.c_void_p]
        entry.restype = ctypes.c_int
        _ENTRIES[(name, fn)] = entry
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = entry(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")


def use_cuda_for(x: torch.Tensor, impl: str) -> bool:
    """True when ``impl`` sends a call on ``x`` to the CUDA kernel: "auto"
    and "cuda" do on a CUDA tensor, "ref" never does."""
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl != "ref" and x.is_cuda
