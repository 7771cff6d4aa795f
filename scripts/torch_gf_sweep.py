#!/usr/bin/env python3
"""Where ``gf_matmul``'s time goes: patched builds timed side by side.

Builds ``hbbft_tpu_torch/csrc/gf_matmul.cu`` as shipped and patched
copies of it (each a text patch of the shipped source, built by ``nvcc``
under ``build/hbbft_tpu_torch/sweep/``), then times each on the card's
timeline (calls enqueued behind a sleep, median of the per-call times
of ``--reps`` calls) at the shapes of chip_smoke.py's phase 7 — the
N = 1024 epoch's W = 16 parity, decode and dead rows (a wave's and one
proposer's), the 1 MB broadcast's W = 8 parity and decode — beside
``torch._int_mm`` on the binary expansion's shape (not the same
function: an int8 product with no parity or packing).  The variants:

- ``shipped``: the kernel as it is, its output held against the plain
  version;
- ``no-mma``: without the products (the bulk copies, the symbols and the
  fragments alone);
- ``no-data``: without the data's copies and symbols (A_bin's copies and
  the products alone).

Every variant but ``shipped`` computes garbage on purpose.  The JSON
also goes to ``chiprun_out/torch_gf_sweep.json``; the last line is the
card's name and power limit.  Run from the repo root on a CUDA host:
``python3 scripts/torch_gf_sweep.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "shipped": [],
    "no-mma": [("      wgmma_u8_rs(d, f, db, ks > 0);\n", "")],
    "no-data": [
        ("          bytes += len[rr] = x_span<W>(XR * ks + rr, k, xs, nt, off[rr]);",
         "          len[rr] = 0;"),
        ("      stage_symbols<W>(v, sm.x[stage], k, xs, (tile % NT) * BN, ks, warp, lane);",
         "      v[0] = v[1] = v[2] = v[3] = 0u;"),
    ],
}
# (W, what, columns): the matrices come from the codecs below
SHAPES = [(16, "parity", 974), (16, "decode", 974), (16, "dead rows (a wave)", 974),
          (16, "dead rows (a proposer)", 1), (8, "broadcast parity", 47_663),
          (8, "broadcast decode", 47_663)]
SLEEP_CYCLES = 100_000_000


def patched(label: str, patches):
    """A variant's source tree (every .cu and .cuh of csrc, gf_matmul.cu
    patched) under build/; returns the directory."""
    from hbbft_tpu_torch.ops import kernels

    d = kernels.BUILD_DIR / "sweep" / f"gf_matmul-{label}"
    d.mkdir(parents=True, exist_ok=True)
    files = {p.name: p.read_text() for p in kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for old, new in patches:
        if files["gf_matmul.cu"].count(old) != 1:
            raise RuntimeError(f"{label}: patch anchor not found once: {old[:60]!r}")
        files["gf_matmul.cu"] = files["gf_matmul.cu"].replace(old, new)
    for name, text in files.items():
        (d / name).write_text(text)
    return d


def build(label: str, patches):
    """(library, ptxas lines) of a variant."""
    from hbbft_tpu_torch.ops import kernels

    d = patched(label, patches)
    so = d / "libgf_matmul.so"
    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
                           str(d / "gf_matmul.cu")], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gf_matmul_launch.argtypes = [i, p, p, i, p, i, i, i, p]
    lib.gf_matmul_launch.restype = ctypes.c_int
    log = proc.stdout + proc.stderr
    return lib, [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "C75" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_gf_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from hbbft_tpu_torch.crypto import rs as RS
    from hbbft_tpu_torch.ops import gf256 as GF

    dev = torch.device("cuda")
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        futs = {label: pool.submit(build, label, pt) for label, pt in VARIANTS.items()}
        built = {label: f.result() for label, f in futs.items()}
    out = {"reps": args.reps, "ptxas": {label: b[1] for label, b in built.items()}, "rows": []}

    def device_ms(fn) -> float:
        fn()  # warm-up
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        marks[1].record()
        for _ in range(args.reps):
            fn()
        marks[2].record()
        torch.cuda.synchronize()
        return marks[1].elapsed_time(marks[2]) / args.reps

    k16 = 342
    c16 = RS.ReedSolomon16(k16, 1024 - k16)
    dead = list(range(974, 1024))
    k8 = 22
    c8 = RS.ReedSolomon(k8, 64 - k8)
    mats = {"parity": c16.matrix[k16:],
            "decode": c16.decode_matrix([i for i in range(1024) if i not in dead][:k16]),
            "dead rows (a wave)": c16.matrix[dead], "dead rows (a proposer)": c16.matrix[dead],
            "broadcast parity": c8.matrix[k8:],
            "broadcast decode": c8.decode_matrix(list(range(k8, 2 * k8)))}
    gen = torch.Generator(device=dev).manual_seed(0x6F)
    for W, what, cols in SHAPES:
        mat = mats[what]
        m, k = mat.shape
        xs = -(-cols * W // 128) * 16  # rows padded to 16 bytes
        x = torch.randint(0, 256, (k, xs), dtype=torch.uint8, device=dev, generator=gen)
        data = x.view(torch.uint8 if W == 8 else torch.int16)[:, :cols]
        abin = (GF._abin8 if W == 8 else GF._abin16)(GF._key(mat), device=str(dev))
        want = GF.gf_matmul_plain(mat, data)
        row = {"w": W, "what": what, "shape": [m, k, cols]}
        stream = torch.cuda.current_stream().cuda_stream
        for label, (lib, _) in built.items():
            y = torch.empty((m, cols), dtype=want.dtype, device=dev)

            def call(lib=lib, y=y):
                rc = lib.gf_matmul_launch(W, abin.data_ptr(), x.data_ptr(), xs, y.data_ptr(), m,
                                          k, cols, stream)
                if rc:
                    raise RuntimeError(f"{label}: launch failed ({rc})")

            row[label] = statistics.median(device_ms(call) for _ in range(3))
            if label == "shipped":
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    raise SystemExit(f"torch_gf_sweep: the shipped kernel differs at {what}")
        pad = -(-cols // 8) * 8
        if pad >= 16:
            a8 = torch.randint(0, 2, (W * m, W * k), dtype=torch.int8, device=dev, generator=gen)
            b8 = torch.randint(0, 2, (pad, W * k), dtype=torch.int8, device=dev,
                               generator=gen).t()
            row["int_mm"] = device_ms(lambda: torch._int_mm(a8, b8))
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out["card"] = card
    print("ptxas " + json.dumps(out["ptxas"]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_gf_sweep.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
