"""The port stands alone: no JAX, nothing of ``hbbft_tpu``, no silent CPU.

- every module of ``hbbft_tpu_torch`` (and ``chip_smoke.py`` and
  ``examples/torch_simulation.py``) imports in a fresh interpreter where
  ``jax`` and ``hbbft_tpu`` are blocked;
- no source file of the port, nor ``chip_smoke.py``, the port's
  simulation example (``examples/torch_simulation.py``) or its
  measurement scripts (``scripts/torch_*.py``), has an import of
  ``jax`` or of ``hbbft_tpu`` (as opposed to ``hbbft_tpu_torch``);
- the entry points default to the card and raise without CUDA.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "hbbft_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "hbbft_tpu"):
    sys.modules[blocked] = None  # any import of them now raises
import hbbft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hbbft_tpu_torch.__path__, "hbbft_tpu_torch.")]
assert "hbbft_tpu_torch.parallel.mesh" in names
assert {"hbbft_tpu_torch.ops.sha256", "hbbft_tpu_torch.ops.gf256"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "examples")
import torch_simulation
assert not any(k == "jax" or k.startswith(("jax.", "hbbft_tpu.")) for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def _sources():
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "examples" / "torch_simulation.py"] + scripts


def test_every_module_imports_without_jax_or_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 29


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "hbbft_tpu"), f"{path}:{node.lineno} imports {mod}"


def test_cuda_backend_raises_without_cuda(monkeypatch):
    import random

    from hbbft_tpu_torch.device import resolve_device
    from hbbft_tpu_torch.harness.batching import BatchingBackend
    from hbbft_tpu_torch.harness.cosim import PackedHoneyBadgerCosim, PackedQueueingCosim
    from hbbft_tpu_torch.harness.dkg import VectorizedDkg
    from hbbft_tpu_torch.harness.simulation import simulate_queueing_honey_badger
    from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
    from hbbft_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchingBackend()  # the default inner backend is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorizedDkg(range(4), 1, random.Random(0))  # the DKG's default is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)  # a mesh's default shards are cards
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedHoneyBadgerCosim(4, random.Random(0))  # the co-sim's columns live on the card
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedQueueingCosim(4, random.Random(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_queueing_honey_badger(4, num_txs=4, batch_size=4)  # the simulator's nodes
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_simulation

    with pytest.raises(RuntimeError, match="CUDA"):
        torch_simulation.main(["-n", "4", "-t", "4", "-b", "4"])  # --device cuda by default
    assert PackedHoneyBadgerCosim(4, random.Random(0), device="cpu").device.type == "cpu"
    assert make_mesh(4, device="cpu").devices == [torch.device("cpu")] * 4
    assert VectorizedDkg(range(4), 1, random.Random(0), device="cpu").device.type == "cpu"
    assert CudaBackend(device="cpu").device == torch.device("cpu")
