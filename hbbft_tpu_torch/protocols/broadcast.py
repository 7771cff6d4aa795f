"""Reliable-broadcast payload framing.

The port's own copy of ``frame_into_shards`` and ``unframe_shards`` from
``hbbft_tpu/protocols/broadcast.py`` (reference ``send_shards`` /
``glue_shards``, ``broadcast.rs:341-363`` / ``:697-707``), which the
vectorized epoch's broadcast phase uses.  The sequential ``Broadcast``
state machine is not part of the port yet.
"""

from __future__ import annotations

from typing import List, Optional


def frame_into_shards(
    value: bytes, data_shard_num: int, symbol: int = 1
) -> List[bytes]:
    """Length-prefix + pad + split into equal data shards; shard lengths
    round up to a multiple of the codec's ``symbol`` width (2 for the
    GF(2^16) codec)."""
    payload = len(value).to_bytes(4, "big") + value
    shard_len = max(-(-len(payload) // data_shard_num), 1)
    shard_len = -(-shard_len // symbol) * symbol
    padded = payload.ljust(shard_len * data_shard_num, b"\x00")
    return [
        padded[i * shard_len : (i + 1) * shard_len]
        for i in range(data_shard_num)
    ]


def unframe_shards(shards: List[bytes], data_shard_num: int) -> Optional[bytes]:
    """Inverse of :func:`frame_into_shards`: join + strip the 4-byte
    length header.  None if the header is inconsistent (a malformed
    proposal — the caller attributes the fault)."""
    payload = b"".join(shards[:data_shard_num])
    length = int.from_bytes(payload[:4], "big")
    if length > len(payload) - 4:
        return None
    return payload[4 : 4 + length]
