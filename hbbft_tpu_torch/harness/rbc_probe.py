"""Where a run's reliable-broadcast work went, and what it cost.

:class:`RbcProbe` is a context manager over one backend instance (the one
whose ``sha256_many``, ``merkle_tree``, ``merkle_trees`` and ``rs_codec``
a run calls, or that a ``BatchingBackend`` forwards them to) and,
optionally, one ``VectorizedHoneyBadgerSim`` over it.  While it is open it
wraps those methods as attributes of these two instances alone (no
module global is rebound), and keeps:

- ``sent``: the launches of each RBC kernel that the backend's size rules
  send to the card for the calls seen (``CudaBackend.sha_on_device`` and
  ``forest_on_device``, a device codec's ``rule``): a batch of messages
  one ``sha256``; a tree (a forest of one) or a batch of trees one
  ``merkle_forest``, which hashes its own leaves; a codec product one
  ``gf_matmul``.  A backend without size rules (``CpuBackend``) sends
  none.  A run on the card holds ``cuda_ec.LAUNCHES`` to it.
- ``walls`` and ``calls`` by work: the sim's parity, decode and dead rows'
  products (``_codec_matmul``, in that order within each ``_rbc_phase``:
  one of each a wave), the backend's trees (a call of ``merkle_tree`` or
  ``merkle_trees``: an epoch's wave makes a forest of commitments and a
  roots-only forest of reconstructions) and the sim's independent re-root
  (``_reroot``, a tree a proposer); ``shapes`` has each product's first
  (m, k, byte columns).  Each product and tree returns host data, so a
  wall covers the card's work.

The sim's codec and every device codec made while the probe is open
(``rs_codec``) have their ``matmul`` wrapped too.  The counters are not
locked: a pipelined run's RBC phase, on a worker thread, is seen all the
same, but its walls then overlap the other phases.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from ..ops import gf256 as GF
from ..ops.cuda_ec import RBC_KERNELS
from ..ops.sha256 import forest_shape

SPLIT_KEYS = ("parity", "decode", "dead_rows", "trees", "reroot")


class RbcProbe:
    def __init__(self, ops, sim=None):
        self.ops, self.sim = ops, sim
        self.sent: Dict[str, int] = dict.fromkeys(RBC_KERNELS, 0)
        self.walls: Dict[str, float] = dict.fromkeys(SPLIT_KEYS, 0.0)
        self.calls: Dict[str, int] = dict.fromkeys(SPLIT_KEYS, 0)
        self.shapes: Dict[str, Tuple[int, int, int]] = {}
        self._wrapped: List[Tuple[Any, str]] = []

    def _wrap(self, obj, name: str, make: Callable) -> None:
        setattr(obj, name, make(getattr(obj, name)))
        self._wrapped.append((obj, name))

    def _timed(self, key: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.walls[key] += time.perf_counter() - t0
        self.calls[key] += 1
        return out

    def _codec(self, codec):
        """Count the products of a device codec that its rule sends to the
        card (a host codec launches nothing)."""
        if not isinstance(codec, GF.ReedSolomonDevice) or "matmul" in vars(codec):
            return codec

        def make(matmul):
            def counted(rows, data):
                if codec.rule is None or codec.rule(rows.shape[0], rows.shape[1], data.shape[1]):
                    self.sent["gf_matmul"] += 1
                return matmul(rows, data)

            return counted

        self._wrap(codec, "matmul", make)
        return codec

    def __enter__(self):
        ops = self.ops
        on_sha = getattr(ops, "sha_on_device", None)
        on_forest = getattr(ops, "forest_on_device", None)

        def count_forest(groups) -> None:
            shape = forest_shape(groups)
            if on_forest is not None and shape is not None and on_forest(*shape):
                self.sent["merkle_forest"] += 1

        def sha256_many(fn):
            def counted(items):
                items = list(items)
                if on_sha is not None and on_sha(items):
                    self.sent["sha256"] += 1
                return fn(items)

            return counted

        def merkle_tree(fn):
            def counted(values):
                values = list(values)
                count_forest([values])
                return self._timed("trees", fn, values)

            return counted

        def merkle_trees(fn):
            def counted(groups, roots_only=False):
                if not isinstance(groups, np.ndarray):
                    groups = [list(g) for g in groups]
                count_forest(groups)
                return self._timed("trees", fn, groups, roots_only)

            return counted

        def rs_codec(fn):
            return lambda *args, **kw: self._codec(fn(*args, **kw))

        self._wrap(ops, "sha256_many", sha256_many)
        self._wrap(ops, "merkle_tree", merkle_tree)
        self._wrap(ops, "merkle_trees", merkle_trees)
        self._wrap(ops, "rs_codec", rs_codec)
        if self.sim is not None:
            self._wrap_sim(self.sim)
        return self

    def _wrap_sim(self, sim) -> None:
        order = [0]

        def rbc_phase(fn):
            def reset(*args, **kw):
                order[0] = 0
                return fn(*args, **kw)

            return reset

        def codec_matmul(fn):
            def timed(rows, byte_mat):
                key = SPLIT_KEYS[min(order[0], 2)]
                order[0] += 1
                self.shapes.setdefault(key, (rows.shape[0], rows.shape[1], byte_mat.shape[1]))
                return self._timed(key, fn, rows, byte_mat)

            return timed

        self._codec(sim.codec)
        self._wrap(sim, "_rbc_phase", rbc_phase)
        self._wrap(sim, "_codec_matmul", codec_matmul)
        self._wrap(sim, "_reroot", lambda fn: lambda values: self._timed("reroot", fn, values))

    def __exit__(self, *exc):
        for obj, name in reversed(self._wrapped):
            delattr(obj, name)
        self._wrapped.clear()
        return False
