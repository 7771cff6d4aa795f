"""Common Coin — unique threshold signatures as shared randomness.

The port's own copy of ``hbbft_tpu/protocols/common_coin.py`` (reference
``src/common_coin.rs``).  On input, each validator signs the round nonce
with its threshold key share and multicasts the share; incoming shares
are verified through ``netinfo.ops.verify_sig_share`` (bad shares are
attributed as faults); once > f verified shares are present *and* we
provided input, the shares are Lagrange-combined, the combined signature
is verified against the master key, and its parity bit is the coin.
Under ``harness.batching.BatchingBackend`` the share checks of a whole
network are settled in one flush whose G1 aggregate runs on the card.
``make_nonce`` binds the coin to the network, the HoneyBadger epoch, the
proposer and the agreement epoch; the vectorized agreement signs the
same bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..core.algorithm import CryptoError, DistAlgorithm, UnknownSenderError
from ..core.fault import FaultKind
from ..core.network_info import NetworkInfo
from ..core.serialize import wire
from ..core.step import Step


@wire("CoinMsg")
@dataclasses.dataclass(frozen=True)
class CommonCoinMessage:
    share: Any  # SignatureShare (real or mock)


class CommonCoin(DistAlgorithm):
    """One coin flip, named by a unique ``nonce``."""

    def __init__(self, netinfo: NetworkInfo, nonce: bytes):
        self.netinfo = netinfo
        self.nonce = bytes(nonce)
        self.received_shares: Dict[Any, Any] = {}
        self.had_input = False
        self._terminated = False

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, _input=None) -> Step:
        """Sends our threshold signature share if not yet sent."""
        if self.had_input:
            return Step()
        self.had_input = True
        return self._get_coin()

    def handle_message(self, sender_id, message) -> Step:
        if self._terminated:
            return Step()
        if not isinstance(message, CommonCoinMessage):
            return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
        return self._handle_share(sender_id, message.share)

    def terminated(self) -> bool:
        return self._terminated

    def our_id(self):
        return self.netinfo.our_id

    # -- internals ---------------------------------------------------------

    def _get_coin(self) -> Step:
        if not self.netinfo.is_validator:
            return self._try_output()
        share = self.netinfo.secret_key_share.sign(self.nonce)
        step: Step = Step()
        step.send_all(CommonCoinMessage(share))
        step.extend(self._handle_share(self.netinfo.our_id, share))
        return step

    def _handle_share(self, sender_id, share) -> Step:
        pk_share = self.netinfo.public_key_share(sender_id)
        if pk_share is None:
            raise UnknownSenderError(f"unknown sender {sender_id!r}")
        if sender_id in self.received_shares:
            return Step()
        try:
            ok = self.netinfo.ops.verify_sig_share(pk_share, share, self.nonce)
        except Exception:
            ok = False
        if not ok:
            return Step.from_fault(
                sender_id, FaultKind.INVALID_SIGNATURE_SHARE
            )
        self.received_shares[sender_id] = share
        return self._try_output()

    def _try_output(self) -> Step:
        if not self.had_input or len(self.received_shares) <= self.netinfo.num_faulty:
            return Step()
        sig = self._combine_and_verify_sig()
        self._terminated = True
        return Step.with_output(sig.parity())

    def _combine_and_verify_sig(self):
        shares_by_idx = {
            self.netinfo.node_index(nid): share
            for nid, share in self.received_shares.items()
        }
        pk_set = self.netinfo.public_key_set
        sig = pk_set.combine_signatures(shares_by_idx)
        if not pk_set.verify_signature(sig, self.nonce):
            # All contributing shares verified individually, so a failing
            # master signature indicates a local bug, not remote
            # Byzantine behaviour — abort loudly (reference
            # ``common_coin.rs:192-204``).
            raise CryptoError("combined coin signature failed verification")
        return sig


def make_nonce(
    invocation_id: bytes, session_id: int, proposer_index: int, epoch: int
) -> bytes:
    """Unique coin nonce binding the network invocation, HB session
    (epoch), proposer, and agreement epoch (reference
    ``agreement/mod.rs:154-166``)."""
    return (
        b"hbbft_tpu coin nonce|"
        + invocation_id
        + b"|%d|%d|%d" % (session_id, proposer_index, epoch)
    )
