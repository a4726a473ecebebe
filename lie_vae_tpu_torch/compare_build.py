"""Time the kernels' build with and without nvcc's split compilation on the
host of a card, and check that both give the same machine code.

    python -m lie_vae_tpu_torch.compare_build

Builds the three CUDA sources as ``chip_smoke.py``'s build phase does (one
nvcc each, all started together) into ``build/compare_build/``, in turns:
with ``_build.NVCC_FLAGS`` less ``--split-compile=0``, then with them, with
them again, and without. Prints each turn's wall seconds and each
source's, whether each source's SASS (``cuobjdump -sass``, blank lines
dropped) is the same both ways, the card's name and power limit, and a
JSON record as its last line.
"""
import hashlib
import json
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

from lie_vae_tpu_torch.ops.kernels import _build
from lie_vae_tpu_torch.profile_data import _card

SOURCES = ("wigner_chain", "so3_density", "wigner_block")
SPLIT = "--split-compile=0"
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "compare_build")


def build_all(flags, tag):
    """(wall s, {source: s}) of building every source with ``flags`` at
    once, the libraries named ``<source>-<tag>.so``."""
    def one(name):
        t0 = time.perf_counter()
        subprocess.run([_build.nvcc_path(), *flags, "-o",
                        os.path.join(OUT, f"{name}-{tag}.so"),
                        os.path.join(_build.CSRC, name + ".cu")],
                       check=True, capture_output=True)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        each = dict(zip(SOURCES, pool.map(one, SOURCES)))
    return time.perf_counter() - t0, each


def sass_digest(path):
    """A digest of the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], check=True,
                         capture_output=True, text=True).stdout
    text = "\n".join(line for line in out.splitlines() if line.strip())
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def main():
    if SPLIT not in _build.NVCC_FLAGS:
        raise SystemExit(f"_build.NVCC_FLAGS has no {SPLIT}")
    plain = tuple(f for f in _build.NVCC_FLAGS if f != SPLIT)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    turns = []
    for i, split in enumerate((False, True, True, False)):
        wall, each = build_all(_build.NVCC_FLAGS if split else plain,
                               f"{'split' if split else 'plain'}{i}")
        turns.append({"split": split, "s": wall, "each_s": each})
        print(f"turn {i}: {'with' if split else 'without'} {SPLIT}: "
              f"{wall:.2f} s (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in each.items()) + ")",
              flush=True)
    same = {n: sass_digest(os.path.join(OUT, f"{n}-plain0.so"))
            == sass_digest(os.path.join(OUT, f"{n}-split1.so"))
            for n in SOURCES}
    print(f"the same SASS with and without {SPLIT}: {same}")
    shutil.rmtree(OUT, ignore_errors=True)
    record = {"card": _card(), "cpus": os.cpu_count(), "turns": turns,
              "same_sass": same}
    print(record["card"])
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
