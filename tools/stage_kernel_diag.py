"""Where the fused verify-stage kernel's time goes, on one CUDA GPU.

Builds the kernel library as ``walt_tpu_torch.kernels`` does, plus variants
of ``csrc/verify_stage.cu`` with one part taken out (their results are
wrong; only their times matter):

- ``no_stage``: the block's conv range is never staged in shared memory;
- ``no_genome``: no genome-word gathers;
- ``no_index``: no index-entry gather (positions hashed from the entry
  index instead);
- ``no_loads``: none of the three.

Times each (device time, torch.profiler, in turns: every variant, then
every variant again) on ``chip_smoke.stage_inputs`` worklists at the SE
main-path shape (M = 196,608 rows, B = 131,072 reads, W = 7), against a
16M- and a 128M-entry index, and a plain device copy of the bytes the
kernel's bound counts (at this size the copy fits in the 50 MB L2).

Usage, from the repository root on a machine with a card and nvcc:

    python tools/stage_kernel_diag.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: variant -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "no_stage": [("verify_stage.cu", "if (end16 - a0 <= a.conv_smem_bytes) {",
                  "if (false) {")],
    "no_genome": [("verify_stage_row.h",
                   "f.g[j] = WALTX_LDG(a.pseq + (k < last ? k : last));",
                   "f.g[j] = (uint32_t)k;")],
    "no_index": [("verify_stage_row.h", "f.entry = WALTX_LDG(a.index + e);",
                  "f.entry = (uint32_t)(e * 2654435761u) >> 5;")],
}
VARIANTS["no_loads"] = [e for v in VARIANTS.values() for e in v]


def build_variant(name: str, edits, out_dir: str) -> ctypes.CDLL:
    from walt_tpu_torch import kernels

    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(kernels.CSRC):
        shutil.copy(os.path.join(kernels.CSRC, f), d)
    for f, old, new in edits:
        path = os.path.join(d, f)
        with open(path) as fh:
            src = fh.read()
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in {f}")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    so = os.path.join(d, "libvariant.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", d, "-o",
           so, os.path.join(d, "verify_stage.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.waltx_verify_stage.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.waltx_verify_stage.restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from walt_tpu_torch import kernels
    from walt_tpu_torch.ops import verify

    dev = torch.device("cuda", 0)
    print("card:", cs.card_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "stage_diag")
    libs = {"kernel": kernels.library()}
    libs.update((n, build_variant(n, e, out_dir)) for n, e in VARIANTS.items())

    def run(lib, args, kw):
        M = args[0].shape[0]
        outs = (torch.empty(M, dtype=torch.int64, device=dev),
                torch.empty(M, dtype=torch.int64, device=dev),
                torch.empty(M, dtype=torch.bool, device=dev))
        a = verify.stage_args(args, outs, **kw)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lib.waltx_verify_stage(ctypes.byref(a), dev.index, stream) != 0:
            raise RuntimeError("launch failed")
        return outs

    rng = np.random.default_rng(2025)
    for n_index in (1 << 24, 1 << 27):
        args, kw = cs.stage_inputs(rng, cs.MAIN_M, cs.MAIN_B, cs.MAIN_W,
                                   cs.GENOME_BASES // 16, dev,
                                   n_index=n_index)
        times = {}
        for name in list(libs) * 2:
            ms = cs.device_profile(lambda: run(libs[name], args, kw))[0]
            times.setdefault(name, []).append(ms * 1e3)
        b_ms, b_by = cs.stage_bound(args, kw)
        print(f"index of {n_index} entries, bound {b_ms * 1e3:.2f} us "
              f"({b_by}); device us per call: " + ", ".join(
                  f"{k} {' / '.join(f'{t:.2f}' for t in v)}"
                  for k, v in times.items()), flush=True)
    n = int(b_ms * 1e-3 * cs.HBM_BYTES_PER_S) // 16
    x = torch.empty(n, dtype=torch.int64, device=dev)
    y = torch.empty_like(x)
    ms = cs.device_profile(lambda: y.copy_(x))[0]
    print(f"device copy of {16 * n / 1e6:.1f} MB (read + write): "
          f"{ms * 1e3:.2f} us, {16 * n / ms / 1e6:.0f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
