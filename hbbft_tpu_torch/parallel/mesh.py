"""A mesh of shards for the flush's G1 MSMs and the packed co-sim's
step, and the ring all-reduce.

The port of the mesh-sharded product flush, of the sharded MSMs and
epoch crypto step (``sharded_msm_fn``, ``sharded_windowed_msm_fn``,
``sharded_windowed_g1_msm``, ``sharded_g1_msm``,
``sharded_epoch_crypto_fn``) and of the packed co-sim step
(``packed_cosim_step_fn``) of ``hbbft_tpu/parallel/mesh.py``.  The
reference shards the point axis of a product flush over a
``jax.sharding.Mesh`` under ``shard_map``: each shard unpacks its block
of wires, runs the windowed kernel, builds its per-group trees, and the
``[G, 3, L]`` partials meet in a ring all-reduce of n−1 rounds of
``ring_permute`` and a complete EC add.  The co-sim's step shards its
instance axis the same way; its ``[Z]`` int32 zone histograms meet in
the same ring with an integer add.

Here a :class:`Mesh` is a list of shards, each a ``torch.device`` with
its own CUDA stream.  Shard j of a mesh made on the card runs on
``cuda:(j % torch.cuda.device_count())``, so on one card the shards
run side by side on their streams and the ring moves bytes within
device memory; on several cards the ring kernel stores into the
neighbour card's memory over NVLink.  ``make_mesh(n, device="cpu")``
gives n CPU shards, on which every kernel runs its plain version.

Every sharded function queues shard j's work on shard j's stream, and
hands back tensors that are safe to use on the devices' current streams
(:meth:`Mesh.join`).  The reference's executable cache, runner keys and
its XLA scan engine have no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import cosim_step as CS
from ..ops import cuda_ec
from ..ops import packed_msm as PM
from ..ops import sha256 as SH
from ..ops.ec import g1_kernel, g2_kernel


class Mesh:
    """n shards: ``devices[j]`` and, on CUDA, ``streams[j]``."""

    def __init__(self, devices: Sequence[torch.device]):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.streams: List[Optional[torch.cuda.Stream]] = [
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.devices
        ]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    @contextlib.contextmanager
    def on(self, j: int) -> Iterator[None]:
        """Make shard j's device and stream current (nothing on a CPU shard)."""
        stream = self.streams[j]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[j]), torch.cuda.stream(stream):
            yield

    def fork(self) -> None:
        """Order every shard stream after its device's current stream, so
        tensors made there are ready for the shards."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def join(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Order each device's current stream after its shard's stream, so
        ``tensors[j]`` (made on shard j) is safe to use there."""
        for t, d, s in zip(tensors, self.devices, self.streams):
            if s is not None:
                cur = torch.cuda.current_stream(d)
                cur.wait_stream(s)
                t.record_stream(cur)
        return tensors


def make_mesh(n_shards: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """A 1-D mesh of ``n_shards`` shards (counterpart of the reference's
    ``make_mesh`` ``:59``).  On the card (``device`` None or CUDA) shard
    j runs on ``cuda:((i + j) % device_count())`` for ``cuda:i`` (i = 0
    by default) and the default size is the number of cards;
    ``device="cpu"`` gives ``n_shards`` CPU shards (default 1)."""
    dev = resolve_device(device)
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_shards}")
    if dev.type == "cpu":
        return Mesh([dev] * (n_shards or 1))
    count = torch.cuda.device_count()
    base = dev.index or 0
    n = count if n_shards is None else n_shards
    return Mesh([torch.device("cuda", (base + j) % count) for j in range(n)])


def _ring_reduce(
    local: List[torch.Tensor], add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], mesh: Mesh
) -> List[torch.Tensor]:
    """Ring all-reduce of per-shard partial sums (reference ``:266-285``):
    n−1 rounds of ``ring_permute`` and ``acc = add(acc, msg)`` on each
    shard's stream (a complete EC add for the flush's points, an int32
    add for the co-sim's histograms).  Each shard forwards the buffer it
    RECEIVED, not its accumulator, so every shard folds in every other
    shard's partial once and the sum is replicated; each shard's limbs
    equal the reference's."""
    n = mesh.size
    if n <= 1:
        return list(local)
    acc = list(local)
    msg = list(local)
    for _ in range(n - 1):
        msg = cuda_ec.ring_permute(msg, mesh)
        for j in range(n):
            with mesh.on(j):
                acc[j] = add(acc[j], msg[j])
    return acc


def sharded_product_msm(
    mesh: Mesh,
    shard_wires: List[torch.Tensor],
    shard_sc: List[torch.Tensor],
    n_groups: int,
) -> List[torch.Tensor]:
    """The sharded product engine (reference ``sharded_product_msm_fn``
    ``:304-375``, its windowed-kernel body): shard j holds ``[n_groups ·
    n_shard, 96]`` u8 wires and ``[n_groups · n_shard, nb]`` u8 scalar
    bytes, group-major (``packed_msm._put_shard_blocks``).  Per shard,
    on its stream: unpack, ``cuda_ec.win_g1``, per-group trees; then
    :func:`_ring_reduce`.  Returns every shard's ``[n_groups, 3, L]``
    group sums, all the same points."""
    mesh.fork()
    kern = g1_kernel()
    prods = []
    # every shard's kernel is queued before any shard's tree, so the
    # host's tree launches do not hold the next shard's kernel back
    for j in range(mesh.size):
        with mesh.on(j):
            pts = PM._wire_points_g1(shard_wires[j])
            prods.append(cuda_ec.win_g1(pts, PM._scalar_digits(shard_sc[j])))
    local = []
    for j in range(mesh.size):
        with mesh.on(j):
            local.append(PM._group_tree(prods[j], n_groups))
    return mesh.join(_ring_reduce(local, kern.add, mesh))


def sharded_packed_msm(mesh: Mesh, wires: np.ndarray, sc: np.ndarray) -> torch.Tensor:
    """Flat Σ kᵢ·Pᵢ over host ``wires`` [k, 96] u8 and big-endian scalar
    bytes ``sc`` [k, nb] u8 (reference ``sharded_packed_msm_fn``
    ``:171-233``): shard j takes rows ``[j·m, (j+1)·m)``, m = ⌈k/n⌉,
    zero-padded (all-zero wire = infinity, zero scalar = 0), and sums
    its products with a tree; the reference's ``all_gather`` becomes a
    copy of each shard's ``[3, L]`` to shard 0, then one more
    ``tree_sum``.  Returns ``[3, L]`` on shard 0's device."""
    n = mesh.size
    k = wires.shape[0]
    m = -(-k // n)
    wires = np.concatenate([wires, np.zeros((n * m - k, wires.shape[1]), np.uint8)])
    sc = np.concatenate([sc, np.zeros((n * m - k, sc.shape[1]), np.uint8)])
    kern = g1_kernel()
    shipped = []
    for j, d in enumerate(mesh.devices):
        with mesh.on(j):
            shipped.append(
                (
                    torch.from_numpy(wires[j * m : (j + 1) * m]).to(d),
                    torch.from_numpy(sc[j * m : (j + 1) * m]).to(d),
                )
            )
    mesh.fork()
    partials = []
    for j, (w, s) in enumerate(shipped):
        with mesh.on(j):
            prods = cuda_ec.win_g1(PM._wire_points_g1(w), PM._scalar_digits(s))
            partials.append(kern.tree_sum(prods))
    partials = mesh.join(partials)
    home = mesh.devices[0]
    return kern.tree_sum(torch.stack([p.to(home) for p in partials]))


# ---------------------------------------------------------------------------
# Sharded MSMs and the epoch's crypto step (reference :89-141, :378-449)
# ---------------------------------------------------------------------------
# The reference shards the rows of an MSM over the mesh under
# ``shard_map``, tree-sums each shard's products and all-gathers the
# [3, L] partials into one more tree.  Here each shard runs its rows
# through the port's kernels on its stream and tree-sums them; the
# partials meet in ``_ring_reduce`` with the complete add, which leaves
# the same point on every shard.


def _shard_rows(x, mesh: Mesh, pad: Callable[[int, torch.device], torch.Tensor]) -> List[torch.Tensor]:
    """Rows of ``x`` (a tensor or array) cut into ``mesh.size`` equal
    blocks, ⌈K/n⌉ rows each, padded at the end by ``pad(rows, device)``,
    block j on shard j's device (made on its stream)."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    n = mesh.size
    m = -(-t.shape[0] // n)
    out = []
    for j, d in enumerate(mesh.devices):
        with mesh.on(j):
            blk = t[j * m : (j + 1) * m].to(d)
            if blk.shape[0] < m:
                blk = torch.cat([blk, pad(m - blk.shape[0], d).to(blk.dtype)])
            out.append(blk.contiguous())
    return out


def _zeros_like_rows(x):
    width = tuple(x.shape[1:])
    return lambda rows, d: torch.zeros((rows,) + width, dtype=torch.int32, device=d)


def _bits_to_digits(bits: torch.Tensor) -> torch.Tensor:
    """[K, nbits] msb-first bits → [K, ⌈nbits/4⌉] msb-first 4-bit window
    digits on the same device (``cuda_ec.bits_to_digits`` in torch)."""
    K, nbits = bits.shape
    nwin = -(-nbits // 4)
    padded = torch.nn.functional.pad(bits.to(torch.int32), (nwin * 4 - nbits, 0))
    d = padded.reshape(K, nwin, 4)
    return ((d[..., 0] << 3) | (d[..., 1] << 2) | (d[..., 2] << 1) | d[..., 3]).contiguous()


def _sharded_sum(mesh: Mesh, g2: bool, pts, aux, per_shard) -> torch.Tensor:
    """Σ of ``per_shard(points, aux)`` products over the rows of ``pts``
    and ``aux`` cut over the mesh (identity points, zero aux as padding),
    each shard's tree on its stream, the partials ring-reduced; returns
    shard 0's sum."""
    kern = g2_kernel() if g2 else g1_kernel()
    pt_blocks = _shard_rows(pts, mesh, lambda r, d: kern.identity((r,), d))
    aux_blocks = _shard_rows(aux, mesh, _zeros_like_rows(aux))
    mesh.fork()
    local = []
    for j in range(mesh.size):
        with mesh.on(j):
            local.append(kern.tree_sum(per_shard(pt_blocks[j], aux_blocks[j])))
    return mesh.join(_ring_reduce(local, kern.add, mesh))[0]


def _bit_serial(g2: bool):
    """Per-shard k·P from msb-first bits: ``scan_g1`` on G1; on G2, which
    has no bit-serial kernel, ``win_g2`` on the same scalars' digits."""
    if g2:
        return lambda pts, bits: cuda_ec.win_g2(pts, _bits_to_digits(bits))
    return lambda pts, bits: cuda_ec.scan_g1(pts, bits.to(torch.int32).contiguous())


def sharded_msm_fn(mesh: Mesh, g2: bool = False):
    """The sharded MSM (reference ``:89``): ``run(pts, bits)`` over the
    port's kernel layouts — ``pts`` [K, 3, 38] int32 G1 limbs (or
    [K, 3, 2, 38] on G2), ``bits`` [K, nbits] int32 msb-first scalar bits,
    tensors on any device or arrays — returns Σ kᵢ·Pᵢ as [3, 38] (or
    [3, 2, 38]) limbs on shard 0's device.  Each shard's rows go through
    ``scan_g1`` (G2: ``win_g2`` on the scalars' 4-bit digits), a tree,
    and the ring."""
    per_shard = _bit_serial(g2)

    def run(pts, bits) -> torch.Tensor:
        return _sharded_sum(mesh, g2, pts, bits, per_shard)

    return run


def sharded_windowed_msm_fn(mesh: Mesh, g2: bool = False):
    """The sharded 4-bit windowed MSM (reference ``:114``):
    ``run(pts, digits)`` over the port's kernel layouts — ``pts`` as for
    :func:`sharded_msm_fn`, ``digits`` [K, nwin] int32 msb-first 4-bit
    windows (the reference's tile-transposed layout has no counterpart) —
    returns the sum on shard 0's device.  Each shard's rows go through
    ``win_g1`` (or ``win_g2``), a tree, and the ring."""
    win = cuda_ec.win_g2 if g2 else cuda_ec.win_g1

    def run(pts, digits) -> torch.Tensor:
        return _sharded_sum(mesh, g2, pts, digits, lambda p, d: win(p, d.to(torch.int32)))

    return run


def sharded_windowed_g1_msm(points: Sequence, scalars: Sequence[int], mesh: Optional[Mesh] = None,
                            nbits: int = 255):
    """Host-facing sharded windowed MSM over the port's G1 points
    (reference ``:378``); the mesh defaults to every card."""
    from ..crypto.curve import G1
    from ..ops import limbs as LB
    from ..ops.ec import g1_from_limbs, g1_to_limbs

    if not points:
        return G1.infinity()
    mesh = mesh or make_mesh()
    digits = cuda_ec.bits_to_digits(LB.scalars_to_bits(list(scalars), nbits))
    return g1_from_limbs(sharded_windowed_msm_fn(mesh)(g1_to_limbs(list(points)), digits))


def sharded_g1_msm(points: Sequence, scalars: Sequence[int], mesh: Optional[Mesh] = None):
    """Host-facing sharded bit-serial MSM over the port's G1 points
    (reference ``:437``); the mesh defaults to every card."""
    from ..crypto.curve import G1
    from ..ops import limbs as LB
    from ..ops.ec import g1_from_limbs, g1_to_limbs

    if not points:
        return G1.infinity()
    mesh = mesh or make_mesh()
    bits = LB.scalars_to_bits(list(scalars))
    return g1_from_limbs(sharded_msm_fn(mesh)(g1_to_limbs(list(points)), bits))


def sharded_epoch_crypto_fn(mesh: Mesh):
    """One epoch's batched crypto sharded over the validator axis
    (reference ``:401``): ``step(share_pts, share_bits, pk_pts,
    digests_in)`` over the port's kernel layouts — ``share_pts`` [k, 3, 38]
    G1 shares, ``share_bits`` [k, nbits] msb-first RLC coefficient bits,
    ``pk_pts`` [k, 3, 2, 38] G2 key shares, ``digests_in`` [k, 16] one
    padded SHA-256 block a validator lane (int32 or uint32 words) —
    returns ``(agg_share [3, 38], agg_pk [3, 2, 38], digests [k, 8])`` on
    shard 0's device: the two aggregates of the batched check
    e(Σrᵢσᵢ, P₂)·e(−H, Σrᵢpkᵢ) (``scan_g1``; ``win_g2`` on the digits) and
    the lanes' digests (the ``sha256`` kernel on each shard's
    [k/n, 1, 16] blocks)."""
    g1_msm, g2_msm = sharded_msm_fn(mesh), sharded_msm_fn(mesh, g2=True)

    def step(share_pts, share_bits, pk_pts, digests_in):
        agg1 = g1_msm(share_pts, share_bits)
        agg2 = g2_msm(pk_pts, share_bits)
        if not isinstance(digests_in, torch.Tensor):
            digests_in = torch.from_numpy(
                np.ascontiguousarray(digests_in, dtype=np.uint32).view(np.int32))
        words = SH._words(digests_in, "sharded_epoch_crypto_fn")
        k = words.shape[0]
        lanes = _shard_rows(words, mesh, _zeros_like_rows(words))
        mesh.fork()
        digests = []
        for j in range(mesh.size):
            with mesh.on(j):
                digests.append(SH.sha256(lanes[j][:, None, :]))
        home = mesh.devices[0]
        digests = torch.cat([t.to(home) for t in mesh.join(digests)])[:k]
        return agg1, agg2, digests

    return step


# ---------------------------------------------------------------------------
# The packed co-simulation's step
# ---------------------------------------------------------------------------
# The co-sim (``harness/cosim.py``) keeps the whole network's agreement
# state as [n] columns and resolves an epoch in one step.  The n² vote
# relation factors through the WAN layer's zone product, so an instance's
# yes votes are its proposer's reach row against the zone histogram of
# the live, on-time receivers: O(n·Z), not O(n²) (``ops/cosim_step.py``).
# On a mesh the instance axis is cut into equal shards; each histograms
# its own receivers, and the [Z] partials — the whole cross-node message
# exchange — meet in the ring (int32 adds: exact in any order, so every
# result is byte-identical to one launch).

Cols = Union[torch.Tensor, List[torch.Tensor]]


def cosim_pad(n: int, n_dev: int) -> int:
    """Instance-axis padding for the co-sim step (reference ``:572``):
    zero rows are absorbing (a padded instance counts no votes and is
    definite-0)."""
    return -(-n // n_dev) * n_dev


def packed_cosim_step_fn(mesh: Optional[Mesh], n_zones: int):
    """Build the co-sim's per-epoch step (reference ``:473``).

    ``run(prop_on, dst_on, zone, reach, ovr_mask, ovr_c1, forged_cnt,
    commit, params)`` takes the nine columns of ``ops/cosim_step.py``:
    with ``mesh`` None (or of one shard) each row column is one tensor,
    on a mesh a list of shard j's block on ``mesh.devices[j]`` (equal
    blocks, the instance axis padded by :func:`cosim_pad`); ``reach`` is
    ``[n_zones, n_zones]`` uint8 on any device (copied to each shard's
    where it lies elsewhere); ``params`` is ``(n_live, f)``.  Returns
    ``(accepted, nondef, dec_fail, commit)`` in the same form: int8 0/1
    masks, and ``commit`` advanced in place — the same tensors, the
    counterpart of the reference's donated buffer.

    On the card one device's step is ONE cooperative launch of the
    ``cosim_step`` kernel (histogram, grid barrier, decision); on a mesh
    of S shards each shard launches ``cosim_hist`` on its stream, the
    ``[Z]`` partials meet in S − 1 ring rounds, and each shard launches
    the decision (counted as ``cosim_step``): two launches a shard.  The
    step owns the kernels' scratch (``CosimScratch``), one a shard, made
    on first use and kept zeroed by the kernels, so no epoch pays a
    memset; call a step from one stream a device at a time.  The results
    are ready on the devices' current streams.  CPU tensors run the plain
    versions."""
    Z = int(n_zones)
    if mesh is not None and mesh.size == 1:
        mesh = None
    scratch: Dict[Tuple[int, torch.device], CS.CosimScratch] = {}

    def own(j: int, device: torch.device) -> Optional[CS.CosimScratch]:
        if device.type != "cuda":
            return None
        if (j, device) not in scratch:
            scratch[(j, device)] = CS.CosimScratch(Z, device)
        return scratch[(j, device)]

    def run(
        prop_on: Cols, dst_on: Cols, zone: Cols, reach: torch.Tensor, ovr_mask: Cols,
        ovr_c1: Cols, forged_cnt: Cols, commit: Cols, params: Sequence[int],
    ) -> Tuple[Cols, Cols, Cols, Cols]:
        if tuple(reach.shape) != (Z, Z):
            raise ValueError(f"reach must be [{Z}, {Z}] for this step, got {tuple(reach.shape)}")
        n_live, f = (int(x) for x in params)
        if mesh is None:
            dev = zone.device
            acc, nondef, fail = CS.cosim_step(
                prop_on, dst_on, zone, reach.to(dev), ovr_mask, ovr_c1, forged_cnt, commit,
                n_live, f, scratch=own(0, dev),
            )
            return acc, nondef, fail, commit
        if not all(len(c) == mesh.size for c in (prop_on, dst_on, zone, ovr_mask, ovr_c1,
                                                 forged_cnt, commit)):
            raise ValueError(f"every row column takes one block for each of {mesh.size} shards")
        mesh.fork()
        reaches, partial = [], []
        for j, d in enumerate(mesh.devices):
            with mesh.on(j):
                reaches.append(reach.to(d))
                partial.append(CS.cosim_hist(dst_on[j], zone[j], Z, scratch=own(j, zone[j].device)))
        a = _ring_reduce(partial, torch.add, mesh)
        outs = []
        for j in range(mesh.size):
            with mesh.on(j):
                outs.append(CS.cosim_decide(
                    prop_on[j], zone[j], reaches[j], ovr_mask[j], ovr_c1[j], forged_cnt[j],
                    commit[j], a[j], n_live, f,
                ))
        acc, nondef, fail = (mesh.join([o[k] for o in outs]) for k in range(3))
        return acc, nondef, fail, mesh.join(list(commit))

    return run
