"""The virtual-time simulator's hardware profile.

The port's trimmed copy of ``hbbft_tpu/harness/simulation.py``: only
:class:`HwQuality`, the per-node hardware and network profile of the
reference's timed simulator (``examples/simulation.rs:107-114``), which
the vectorized epoch drivers take as ``hw=`` for their analytic
virtual-time account (``harness/epoch.VirtualEpochTime``).  The
event-driven ``SimNetwork`` and ``simulate_queueing_honey_badger`` are
not ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwQuality:
    """Per-node hardware/network profile (reference ``:107-114``).

    latency: seconds added to every message;
    inv_bw: seconds per byte of upstream serialization;
    cpu_factor: percent CPU speed relative to the simulating host
        (100 = same speed; 50 = twice as slow)."""

    latency: float = 0.1
    inv_bw: float = 8_000 / (2_000_000)  # 2000 kbit/s in s/byte
    cpu_factor: float = 100.0

    @classmethod
    def from_flags(
        cls, lag_ms: float = 100.0, bw_kbit_s: float = 2000.0, cpu_pct: float = 100.0
    ) -> "HwQuality":
        return cls(
            latency=lag_ms / 1000.0,
            inv_bw=8.0 / (bw_kbit_s * 1000.0),
            cpu_factor=cpu_pct,
        )

