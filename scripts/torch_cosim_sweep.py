#!/usr/bin/env python3
"""Where the co-sim step's time goes on the card: patched builds of
``csrc/cosim_step.cu`` timed side by side.

Builds copies of the source under ``build/hbbft_tpu_torch/sweep/
cosim_step-<variant>/`` (one ``nvcc`` each, all at once; the patches live
in this script only):

- ``rows-4``: the source as it is (four rows a thread);
- ``rows-8`` / ``rows-16``: eight or sixteen rows a thread (the int8
  columns in 8- or 16-byte loads), held byte for byte against the plain
  version like ``rows-4``;
- ``no-hist``: the one-launch step without its histogram;
- ``no-decide``: without the decision (loads, histogram, barrier);
- ``no-barrier``: without the grid barrier;
- ``loads-only``: without the histogram and the decision.

The last four skip work and are not checked.  Each build's one-launch
step is timed at n = 1,000 and n = 100,000 (Z = 5, chip_smoke.py's
columns) and its ``cosim_hist`` alone at n = 100,000, on the card's
timeline (``--reps`` launches behind a ``torch.cuda._sleep``), the
builds in turn, ``--rounds`` times.  Beside them, from the unpatched
build: an empty ``<<<1, 32>>>`` kernel's launch, the step's cooperative
grid empty and crossing its grid barrier.  Also each build's ptxas lines
and its kernels' SASS instruction counts (``cuobjdump``).

Prints one JSON object (also written to
``chiprun_out/torch_cosim_sweep.json``), then the card's name and power
limit.  Run from the repo root on a CUDA host:
``python3 scripts/torch_cosim_sweep.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NO_HIST = ("    block_histogram(c, x, c_lo, c_hi, acc, s_buf);\n", "")
NO_DECIDE = ("  decide_chunk(c, x, rows, first * ROWS, a, s_buf, s_dot, true);\n", "")
NO_BARRIER = ("    grid_barrier(c.scratch, start);\n", "")
VARIANTS = {
    "rows-4": [],
    "rows-8": [("constexpr int ROWS = 4; ", "constexpr int ROWS = 8; ")],
    "rows-16": [("constexpr int ROWS = 4; ", "constexpr int ROWS = 16; ")],
    "no-hist": [NO_HIST],
    "no-decide": [NO_DECIDE],
    "no-barrier": [NO_BARRIER],
    "loads-only": [NO_HIST, NO_DECIDE],
}
CHECKED = ("rows-4", "rows-8", "rows-16")


def build_variant(label: str, patches) -> tuple:
    """Patch a copy of ``cosim_step.cu`` and build it; (library, log)."""
    from hbbft_tpu_torch.ops import kernels

    d = kernels.BUILD_DIR / "sweep" / f"cosim_step-{label}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    text = kernels.SOURCES["cosim_step"].read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{label}: patch anchor not found: {old[:60]!r}")
        text = text.replace(old, new)
    (d / "cosim_step.cu").write_text(text)
    so = d / "libcosim_step.so"
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so), str(d / "cosim_step.cu")],
        capture_output=True, text=True, timeout=900,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(log[-1500:])
    return so, log


def sass_counts(so) -> dict:
    """SASS instructions of each kernel in a library (``cuobjdump -sass``)."""
    from hbbft_tpu_torch.ops import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            for name in ("cosim_step_kernelILb1", "cosim_step_kernelILb0", "cosim_hist_kernel"):
                if name in fn:
                    fn = {"cosim_step_kernelILb1": "step (one launch)",
                          "cosim_step_kernelILb0": "decision (a mesh shard)",
                          "cosim_hist_kernel": "cosim_hist"}[name]
                    break
            else:
                fn = None
        elif fn and "/*" in line and ";" in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_cosim_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hbbft_tpu_torch.ops import cosim_step as CS

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        futs = {v: pool.submit(build_variant, v, p) for v, p in VARIANTS.items()}
        builds = {v: f.result() for v, f in futs.items()}
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    libs = {v: CS.bind(ctypes.CDLL(str(so))) for v, (so, _) in builds.items()}
    base = CS._lib

    def device_timed(fn) -> float:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        torch.cuda._sleep(cs.RING_SLEEP_CYCLES)
        marks[1].record()
        for _ in range(args.reps):
            fn()
        marks[2].record()
        torch.cuda.synchronize()
        return marks[1].elapsed_time(marks[2]) / args.reps

    gen = np.random.default_rng(cs.SEED)
    shapes = {}
    for n in (1_000, 100_000):
        cols, reach = cs.cosim_columns(gen, n, 5, n)
        t = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
        shapes[n] = ([t[k] for k in cs.COSIM_ROWS[:3]] + [torch.from_numpy(reach).to(dev)]
                     + [t[k] for k in cs.COSIM_ROWS[3:]] + [n - n // 50, (n - 1) // 3])
    step_args = shapes[100_000]
    hist_args = (step_args[1], step_args[2], 5)

    out = {"build_s": build_s, "reps": args.reps, "variants": {}}
    for v, (so, log) in builds.items():
        out["variants"][v] = {
            "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
            "sass": sass_counts(so),
        }
    try:
        for v in CHECKED:
            CS._lib = lambda lib=libs[v]: lib
            args_k = list(step_args)
            args_k[7] = step_args[7].clone()
            args_p = list(step_args)
            args_p[7] = step_args[7].clone()
            got = CS.cosim_step(*args_k)
            want = CS.cosim_step_plain(*args_p)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(list(got) + [args_k[7]],
                                                          list(want) + [args_p[7]])):
                raise SystemExit(f"torch_cosim_sweep: {v} differs from the plain version")
            if not torch.equal(CS.cosim_hist(*hist_args), CS.cosim_hist_plain(*hist_args)):
                raise SystemExit(f"torch_cosim_sweep: {v}'s cosim_hist differs")
        for _ in range(args.rounds):
            for v, lib in libs.items():
                CS._lib = lambda lib=lib: lib
                rec = out["variants"][v]
                for n, a in shapes.items():
                    CS.cosim_step(*a)  # warm-up
                    rec.setdefault(f"step_ms_n{n}", []).append(
                        device_timed(lambda a=a: CS.cosim_step(*a)))
                CS.cosim_hist(*hist_args)
                rec.setdefault("hist_ms_n100000", []).append(
                    device_timed(lambda: CS.cosim_hist(*hist_args)))
        CS._lib = lambda: libs["rows-4"]
        blocks = CS.step_blocks(100_000, dev)
        words = torch.zeros(4, dtype=torch.int32, device=dev)
        probes = {
            "empty_kernel_ms": lambda: CS.launch_probe("empty", dev),
            "grid_empty_ms": lambda: CS.launch_probe("grid", dev, blocks),
            "grid_barrier_ms": lambda: CS.launch_probe("barrier", dev, blocks, words),
        }
        out["step_blocks_n100000"] = blocks
        for _ in range(args.rounds):
            for name, fn in probes.items():
                fn()
                out.setdefault(name, []).append(device_timed(fn))
    finally:
        CS._lib = base
    out["card"] = cs.card_line()
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_cosim_sweep.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
