"""The windowed G1 scalar multiplication of the port (``ops/cuda_ec.py``).

On the CPU the wrapper runs the kernel's plain PyTorch version, which
must give the reference Pallas kernel's limbs exactly
(``pallas_ec.scalar_mul_windowed(..., interpret=True)``; that compile
takes minutes on a CPU, so the exact-limb case is marked slow) and the
reference host curve's k·P by wire bytes (tier-1, at the flush's
96-bit scalar width).  The kernels' one field header
(``csrc/bls_mont.cuh``) must hold the Python field's modulus and entry
table, since the kernels cannot run here, and an edit to it must change
every kernel's build tag.
"""

import random
import re

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import curve as RC
from hbbft_tpu.ops import ec_jax as RE
from hbbft_tpu.ops import limbs as RL
from hbbft_tpu.ops import pallas_ec as RPE
from hbbft_tpu_torch.crypto import curve as PC
from hbbft_tpu_torch.ops import cuda_ec, ec as PE, kernels, limbs as PL

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)


def _points(seed: int, n: int):
    rng = random.Random(seed)
    ks = [rng.randrange(1, 1 << 64) for _ in range(n)]
    return [PC.G1_GEN * k for k in ks] + [PC.G1.infinity()], ks


def test_bits_to_digits_matches_reference():
    rng = random.Random(1)
    ks = [rng.randrange(0, 1 << 61) for _ in range(6)]  # short top window
    bits = PL.scalars_to_bits(ks, 61)
    assert np.array_equal(bits, RL.scalars_to_bits(ks, 61))
    assert np.array_equal(cuda_ec.bits_to_digits(bits), RPE.bits_to_digits(bits))


def test_windowed_plain_matches_host_96bit():
    """K = 7 (not a multiple of 128), an identity row, a zero scalar and
    96-bit scalars (the flush's width): the points and k·P come from the
    reference's host curve, the points enter through the reference's
    ``g1_to_limbs``, and the results must have k·P's wire bytes."""
    rng = random.Random(2)
    ref_pts = [RC.G1_GEN * rng.randrange(1, 1 << 64) for _ in range(6)]
    ref_pts.append(RC.G1.infinity())
    ks = [rng.randrange(0, 1 << 96) for _ in ref_pts]
    ks[1] = 0
    limbs = torch.from_numpy(np.asarray(RE.g1_to_limbs(ref_pts)))
    before = dict(cuda_ec.LAUNCHES)
    out = cuda_ec.scalar_mul_windowed(limbs, PL.scalars_to_bits(ks, 96))
    assert out.shape == (7, 3, 38) and out.dtype == torch.int32
    assert cuda_ec.LAUNCHES == before  # CPU tensors never count a launch
    for i, (p, k) in enumerate(zip(ref_pts, ks)):
        assert PE.g1_from_limbs(out[i]).to_bytes() == (p * k).to_bytes(), i


@pytest.mark.slow
def test_windowed_plain_exact_vs_pallas_interpret():
    """Exact limbs against the reference Pallas kernel in interpret mode
    (one tile, 8-bit scalars as in tests/test_pallas_ec.py; the
    interpret-mode compile takes minutes on a CPU)."""
    rng = random.Random(4)
    ks_pts = [rng.randrange(1, 1 << 64) for _ in range(6)]
    ref_pts = [RC.G1_GEN * k for k in ks_pts] + [RC.G1.infinity()]
    ks = [rng.randrange(0, 256) for _ in ref_pts]
    ks[2] = 0
    limbs = RE.g1_to_limbs(ref_pts)
    bits = RL.scalars_to_bits(ks, 8)
    ref = np.asarray(RPE.scalar_mul_windowed(limbs, bits, interpret=True))
    got = cuda_ec.scalar_mul_windowed(torch.from_numpy(limbs), bits).numpy()
    assert np.array_equal(ref, got)


def test_digit_outside_window_range_selects_identity():
    """The reference's masked cascade falls through to table[0] for a
    digit outside 1..15; the plain version (and the kernel) do too."""
    pts, _ = _points(5, 2)
    limbs = torch.from_numpy(PE.g1_to_limbs(pts))
    digits = torch.tensor([[16], [-1], [0]], dtype=torch.int32)
    out = cuda_ec.win_g1(limbs, digits)
    for i in range(3):
        assert PE.g1_from_limbs(out[i]).is_infinity()


def test_win_g1_checks_its_inputs():
    limbs = torch.zeros((2, 3, 38), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_ec.win_g1(limbs.to(torch.int64), torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_ec.win_g1(limbs, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_ec.win_g1(limbs[:, :2], torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_ec.win_g1(limbs.to("meta"), torch.zeros((2, 1), dtype=torch.int32, device="meta"))


def test_cuda_source_constants_match_field():
    """The __constant__ tables of the one field header are the limb
    field's (the kernels run only on the card): p's words are
    ``limbs.fq().p`` and the entry table takes ``FQ_LIMBS`` limbs of
    ``LIMB_BITS`` bits.  Every scalar-mul kernel includes that header and
    defines no table of its own; the ring kernel is a copy and includes
    no field code."""
    includes = {"win_g1": "bls_mont.cuh", "win_g2": "bls_mont.cuh", "scan_g1": "bls_mont.cuh"}
    for name, path in kernels.SOURCES.items():
        text = path.read_text()
        found = [h for h in ("bls_fq.cuh", "bls_mont.cuh") if f'#include "{h}"' in text]
        assert found == ([includes[name]] if name in includes else []), name
        assert "__constant__" not in text, name  # one copy of the tables
    src = (kernels.CSRC / "bls_mont.cuh").read_text()

    def table(name):
        body = re.search(r"\b" + name + r"(?:\[\w*\])+\s*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]

    def words(x):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(12)]

    f = PL.fq()
    r = 1 << 384
    assert table("P_W") == words(f.p)
    to_mont = table("TO_MONT")
    assert len(to_mont) == 12 * PL.FQ_LIMBS
    for i in range(PL.FQ_LIMBS):
        assert to_mont[12 * i : 12 * (i + 1)] == words((1 << (PL.LIMB_BITS * i)) * r * r % f.p), i
    assert re.search(r"constexpr int L = (\d+);", src).group(1) == str(PL.FQ_LIMBS)
    assert re.search(r"constexpr int LIMB_BITS = (\d+);", src).group(1) == str(PL.LIMB_BITS)


def test_header_edit_changes_every_kernel_tag(tmp_path, monkeypatch):
    """A library's build tag hashes its source and the shared headers,
    so an edit to bls_mont.cuh never leaves a stale build in place, and an
    edit to one source changes only that source's tag."""
    for path in kernels.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(
        kernels, "SOURCES", {n: tmp_path / p.name for n, p in kernels.SOURCES.items()}
    )
    before = {n: kernels.lib_path(n) for n in kernels.SOURCES}
    assert set(before) == {"win_g1", "win_g2", "scan_g1", "ring_permute", "fr_matmul", "cosim_step",
                           "sha256", "merkle", "gf_matmul"}
    assert len(set(before.values())) == 9
    header = tmp_path / "bls_mont.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: kernels.lib_path(n) for n in kernels.SOURCES}
    assert all(after[n] != before[n] for n in before)
    ring = tmp_path / "ring_permute.cu"
    ring.write_text(ring.read_text() + "\n// edited\n")
    again = {n: kernels.lib_path(n) for n in kernels.SOURCES}
    assert [n for n in again if again[n] != after[n]] == ["ring_permute"]


def test_sweep_variants_patch_the_shipped_sources():
    """Every launch-shape and build variant of scripts/torch_win_sweep.py
    is a text patch of a copy of the sources: each must find its
    anchors in the shipped files and change them, or the sweep would
    time the default under another name.  The shipped sources carry no
    variant switches."""
    import importlib.util

    path = kernels.PKG_DIR.parent / "scripts" / "torch_win_sweep.py"
    spec = importlib.util.spec_from_file_location("torch_win_sweep", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    shipped = {p.name: p.read_text() for p in kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for text in shipped.values():
        assert "#ifndef WIN_" not in text and "FE_MUL_" not in text
    for name, variants in sweep.VARIANTS.items():
        labels = [label for label, _ in variants]
        assert len(set(labels)) == len(labels), name
        for label, patches in variants:
            files = dict(shipped)
            for patch in patches:
                patch(files, name)
            assert files != shipped, (name, label)
            assert files["ring_permute.cu"] == shipped["ring_permute.cu"]
