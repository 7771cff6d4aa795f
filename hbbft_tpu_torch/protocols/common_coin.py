"""The common coin's nonce.

The port's own copy of ``make_nonce`` from
``hbbft_tpu/protocols/common_coin.py``: the vectorized agreement signs
these bytes for its real threshold coin, so they must match the
reference byte for byte.  The sequential ``CommonCoin`` state machine is
not part of the port yet.
"""

from __future__ import annotations


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
