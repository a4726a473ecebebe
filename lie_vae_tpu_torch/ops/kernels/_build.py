"""Build a CUDA source of this package into a plain-C shared library, to be
loaded with ``ctypes``.

The build runs ``nvcc`` once per source content, at first use, into
``build/kernels/`` beside the package (a directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The sources include no PyTorch header, so a build takes seconds. ptxas's
report of each kernel's registers, stack frame and spills (``-Xptxas -v``,
which leaves the binary as it is) is kept in ``lib<name>-<hash>.ptxas.txt``
beside the library. A failed build raises; nothing falls back to a plain
version.
"""
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path():
    """The nvcc on PATH, else the one under CUDA_HOME (/usr/local/cuda)."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels of lie_vae_tpu_torch are built with it")


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is built: its file name
    carries a hash of the source and the flags."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def ptxas_log_path(name):
    """Where the build of ``csrc/<name>.cu`` leaves ptxas's report."""
    return library_path(name)[:-len(".so")] + ".ptxas.txt"


def build(name):
    """Compile ``csrc/<name>.cu`` unless a library of the same source is
    already built; returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}:\n{' '.join(cmd)}\n{proc.stdout}"
                           f"{proc.stderr}")
    with open(ptxas_log_path(name), "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)        # atomic: concurrent builders never see half
    print(f"built {os.path.basename(out)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return out

