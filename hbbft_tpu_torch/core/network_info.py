"""Shared per-node network and crypto context.

The port's own copy of ``NetworkInfo`` from
``hbbft_tpu/core/network_info.py`` (reference ``src/messaging.rs:
220-401``): who the validators are, what f is, which keys a node holds,
and the ``ops`` backend every batched crypto call goes through.

The port's default backend is the card: with no ``ops``, ``NetworkInfo``
and ``generate_map`` use ``CudaBackend()``, which raises when CUDA is
absent.  An explicit ``ops`` is used as given: ``CudaBackend(device="cpu")``
(the card's path with every kernel's plain PyTorch version),
``crypto.backend.CpuBackend()``, a mesh backend.  Nothing drops to the
host on its own.
"""

from __future__ import annotations

import hashlib
import random
from typing import Any, Dict, Generic, List, Optional, TypeVar

from ..crypto import mock as M
from ..crypto import threshold as T

N = TypeVar("N")


def resolve_ops(ops: Any = None) -> Any:
    """``ops`` when given, else the card's ``CudaBackend()``."""
    if ops is not None:
        return ops
    from ..ops.backend_cuda import CudaBackend

    return CudaBackend()


class NetworkInfo(Generic[N]):
    """Immutable network/crypto context shared by all protocol instances
    of one node."""

    def __init__(
        self,
        our_id: N,
        secret_key_share: Any,
        secret_key: Any,
        public_key_set: Any,
        public_keys: Dict[N, Any],
        ops: Any = None,
    ):
        if not public_keys:
            raise ValueError("validator set must be non-empty")
        self._our_id = our_id
        self._secret_key_share = secret_key_share
        self._secret_key = secret_key
        self._public_key_set = public_key_set
        self._public_keys = dict(public_keys)
        self._all_ids: List[N] = sorted(public_keys)
        self._node_indices: Dict[N, int] = {
            nid: i for i, nid in enumerate(self._all_ids)
        }
        self._is_validator = our_id in self._node_indices
        self._public_key_shares: Dict[N, Any] = {
            nid: public_key_set.public_key_share(i)
            for nid, i in self._node_indices.items()
        }
        self.ops = resolve_ops(ops)

    # -- identity ----------------------------------------------------------

    @property
    def our_id(self) -> N:
        return self._our_id

    @property
    def our_index(self) -> Optional[int]:
        return self._node_indices.get(self._our_id)

    @property
    def is_validator(self) -> bool:
        """Non-validators (observers) handle all messages but send
        nothing (reference ``messaging.rs:348``)."""
        return self._is_validator

    # -- topology ----------------------------------------------------------

    @property
    def all_ids(self) -> List[N]:
        return self._all_ids

    @property
    def num_nodes(self) -> int:
        return len(self._all_ids)

    @property
    def num_faulty(self) -> int:
        """f = ⌊(N−1)/3⌋ (reference ``messaging.rs:258``)."""
        return (len(self._all_ids) - 1) // 3

    @property
    def num_correct(self) -> int:
        """N − f (reference ``messaging.rs:292-294``)."""
        return len(self._all_ids) - self.num_faulty

    def node_index(self, nid: N) -> Optional[int]:
        return self._node_indices.get(nid)

    def is_node_validator(self, nid: N) -> bool:
        return nid in self._node_indices

    # -- keys --------------------------------------------------------------

    @property
    def secret_key_share(self) -> Any:
        return self._secret_key_share

    @property
    def secret_key(self) -> Any:
        return self._secret_key

    @property
    def public_key_set(self) -> Any:
        return self._public_key_set

    def public_key_share(self, nid: N) -> Any:
        return self._public_key_shares.get(nid)

    def public_key(self, nid: N) -> Any:
        return self._public_keys.get(nid)

    @property
    def public_key_map(self) -> Dict[N, Any]:
        return dict(self._public_keys)

    def invocation_id(self) -> bytes:
        """Unique id of this protocol invocation = master public key bytes
        (reference ``messaging.rs:342-344``); bound into coin nonces."""
        return self._public_key_set.public_key().to_bytes()

    def default_rng(self, label: str = "") -> random.Random:
        """A deterministic per-node RNG, the default of every protocol
        built without one (the reference's derivation, byte for byte, so
        both packages draw the same stream).

        RFC6979-style derivation: the seed hashes the invocation id,
        our node id, a per-consumer ``label``, and — when we hold one —
        our individual secret key.  Two runs of the same node over the
        same network produce the identical stream (replayable,
        co-simulation-stable), while the stream stays unpredictable to
        other parties because the secret key is folded in.  Observers
        (no secret key) still get a deterministic stream; they never
        use it for anything secrecy-bearing (they propose nothing).
        Callers needing fresh OS entropy instead (e.g. first-node key
        generation) pass an explicit rng."""
        h = hashlib.sha256()
        h.update(b"hbbft_tpu/default_rng/v1|")
        h.update(self.invocation_id())
        h.update(b"|" + repr(self._our_id).encode())
        h.update(b"|" + label.encode())
        if self._secret_key is not None:
            h.update(b"|sk|" + repr(self._secret_key).encode())
        if self._secret_key_share is not None:
            h.update(b"|sks|" + repr(self._secret_key_share).encode())
        return random.Random(int.from_bytes(h.digest(), "big"))

    # -- test key dealing --------------------------------------------------

    @staticmethod
    def generate_map(
        ids, rng, mock: bool = False, ops: Any = None
    ) -> Dict[N, "NetworkInfo[N]"]:
        """Deal threshold + individual keys for all nodes centrally
        (reference ``messaging.rs:359-400``; testing and co-simulation
        only).  Draws from ``rng`` in the reference's order: the key
        set's polynomial, then one secret key per id in sorted order.
        With ``mock=True`` the insecure fast mock crypto is dealt
        instead.  Every node shares one ``ops`` (:func:`resolve_ops`)."""
        ops = resolve_ops(ops)
        ids = sorted(ids)
        num_faulty = (len(ids) - 1) // 3
        if mock:
            sk_set = M.MockSecretKeySet.random(num_faulty, rng)
            sec_keys = {nid: M.MockSecretKey.random(rng) for nid in ids}
        else:
            sk_set = T.SecretKeySet.random(num_faulty, rng)
            sec_keys = {nid: T.SecretKey.random(rng) for nid in ids}
        pk_set = sk_set.public_keys()
        key_shares = [sk_set.secret_key_share(i) for i in range(len(ids))]
        if hasattr(pk_set, "seed_share_cache_from_scalars"):
            # the dealer holds every share scalar: one shared-base comb
            # pass fills the cache every NetworkInfo below hits
            pk_set.seed_share_cache_from_scalars(
                {i: ks.scalar for i, ks in enumerate(key_shares)}
            )
        pub_keys = {nid: sk.public_key() for nid, sk in sec_keys.items()}
        return {
            nid: NetworkInfo(
                nid, key_shares[i], sec_keys[nid], pk_set, pub_keys, ops=ops
            )
            for i, nid in enumerate(ids)
        }

    def observer_view(self, observer_id: N, secret_key: Any = None) -> "NetworkInfo[N]":
        """A non-validator view of the same network (observers verify
        everything but hold no key share; reference test harness
        ``tests/network/mod.rs:402-420``)."""
        return NetworkInfo(
            observer_id,
            None,
            secret_key,
            self._public_key_set,
            self._public_keys,
            ops=self.ops,
        )

    def __repr__(self) -> str:
        return (
            f"NetworkInfo(our_id={self._our_id!r}, n={self.num_nodes}, "
            f"f={self.num_faulty}, validator={self.is_validator})"
        )
