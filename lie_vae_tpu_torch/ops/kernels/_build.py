"""Build a CUDA source of this package into a plain-C shared library, to be
loaded with ``ctypes``; and the host C++ source of the data path likewise.

The build runs ``nvcc`` once per source content, at first use, into
``build/kernels/`` beside the package (a directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 \
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The sources include no PyTorch header, so a build takes seconds.
``--split-compile=0`` runs nvcc's optimisation passes on as many threads
as the host has CPUs; the SASS of each of the three sources is the same
with it as without (CUDA 12.9). ptxas's
report of each kernel's registers, stack frame and spills (``-Xptxas -v``,
which leaves the binary as it is) is kept in ``lib<name>-<hash>.ptxas.txt``
beside the library. A failed build raises; nothing falls back to a plain
version.

The host library (``csrc/render_native.cpp``: the native renderer and the
PNG unfilter) builds the same way with ``g++ -O3 -shared -fPIC`` (no
``-ffast-math``) into ``build/native/``, keyed by a hash of the source
(:func:`build_host`); a failed or impossible build raises too.
"""
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")


def nvcc_path():
    """The nvcc on PATH, else the one under CUDA_HOME (/usr/local/cuda)."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels of lie_vae_tpu_torch are built with it")


def _keyed_path(src, flags, build_dir, name):
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(build_dir, f"lib{name}-{digest.hexdigest()[:16]}.so")


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is built: its file name
    carries a hash of the source and the flags."""
    return _keyed_path(os.path.join(CSRC, name + ".cu"), NVCC_FLAGS,
                       BUILD_DIR, name)


def host_library_path(name):
    """Where the host library of ``csrc/<name>.cpp`` is built, keyed as
    :func:`library_path` keys a CUDA one."""
    return _keyed_path(os.path.join(CSRC, name + ".cpp"), GXX_FLAGS,
                       HOST_BUILD_DIR, name)


def ptxas_log_path(name):
    """Where the build of ``csrc/<name>.cu`` leaves ptxas's report."""
    return library_path(name)[:-len(".so")] + ".ptxas.txt"


def _compile(compiler, flags, src, out, name):
    """Run ``compiler flags -o <tmp> src`` and move the result to ``out``
    atomically; raises with the compiler's output if it fails or is
    missing. Returns the compiler's stderr."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # one file per builder: processes and the threads of one process (a
    # threaded loader's first batches) may build the same library at once
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, src]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{compiler} could not run building {name}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed ({proc.returncode}) building "
                           f"{name}:\n{' '.join(cmd)}\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)        # atomic: concurrent builders never see half
    print(f"built {os.path.basename(out)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return proc.stderr


def build(name):
    """Compile ``csrc/<name>.cu`` unless a library of the same source is
    already built; returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    log = _compile(nvcc_path(), NVCC_FLAGS, os.path.join(CSRC, name + ".cu"),
                   out, name)
    with open(ptxas_log_path(name), "w") as f:
        f.write(log)
    return out


def build_host(name):
    """Compile ``csrc/<name>.cpp`` with ``g++`` unless a library of the same
    source is already built; returns the library's path."""
    out = host_library_path(name)
    if not os.path.exists(out):
        _compile("g++", GXX_FLAGS, os.path.join(CSRC, name + ".cpp"), out,
                 name)
    return out
