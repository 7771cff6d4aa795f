"""Virtual-time benchmark simulator.

The port's copy of ``hbbft_tpu/harness/simulation.py``: the reference's
timed network simulator (``examples/simulation.rs``), an event-driven
simulated network where each node has a hardware profile
:class:`HwQuality` (latency, inverse bandwidth, CPU factor).  The wall
time spent inside ``handle_message`` is measured and scaled by the CPU
factor (``simulation.rs:183-196``); upstream bandwidth adds a
serialization delay per byte (``:199-223``); the node with the earliest
next event handles one message per step (``:312-332``).  Per-epoch
statistics (Epoch, Min/Max time-to-batch, Txs, cumulative Msgs/Node,
Size/Node) match the reference's output table (``:352-385``).

With a batching backend (``ops=BatchingBackend(...)``) and real crypto,
each message's share verifications are extracted when it is enqueued
(``harness/batching.crypto_obligations``) and flushed every
``num_nodes`` steps in one ``BatchingBackend.prefetch``, whose G1
aggregate runs the ``win_g1`` kernel on the card when the backend's
size band lets it; protocol outputs are byte-identical to the unbatched
run.  :class:`HwQuality` is also the ``hw=`` profile of the vectorized
epoch drivers (``harness/epoch.VirtualEpochTime``).

The clock is ``_time.perf_counter`` at four sites; replacing this
module's ``_time`` with a deterministic counter makes a run's virtual
times exact.  Left out against the reference: the trace recorder's
events (``obs/`` is not ported) and the ``__setstate__`` shims for old
checkpoints (the port does not pickle protocol state).
"""

from __future__ import annotations

import dataclasses
import heapq
import random as _random
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.network_info import NetworkInfo
from ..core.serialize import dumps
from ..core.step import Step


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


class SimNode:
    """A simulated node with its own virtual clock (reference
    ``TestNode``, ``simulation.rs:117-255``)."""

    def __init__(self, algo, initial_step: Optional[Step], hw: HwQuality, dead: bool = False):
        self.id = algo.our_id()
        self.algo = algo
        self.hw = hw
        self.dead = dead
        self.time = 0.0  # simulated CPU clock
        self.sent_time = 0.0  # last upstream-send completion
        self.in_queue: List[Tuple[float, int, Any, Any, int]] = []  # heap
        self._seq = 0
        self.out_queue: List[Tuple[float, Any, Any, int]] = []
        self.outputs: List[Tuple[float, Any]] = []
        self.message_count = 0
        self.message_size = 0
        # crypto obligations extracted at enqueue time, drained by the
        # batched prefetch; populated only when the network runs a
        # batching backend over real crypto
        self.pending_obs: List[Any] = []
        # scheduler version: stamps the node's live event-heap entry
        # (see SimNetwork._push_event)
        self.sched_ver = 0
        if initial_step is not None and not dead:
            self._send_output_and_msgs(initial_step, 0.0)

    # -- queue -------------------------------------------------------------

    def add_message(self, arrival: float, sender_id, message, size: int) -> None:
        if self.dead:
            return
        self._seq += 1
        heapq.heappush(self.in_queue, (arrival, self._seq, sender_id, message, size))

    def next_event_time(self) -> Optional[float]:
        if self.dead or not self.in_queue:
            return None
        return max(self.in_queue[0][0], self.time)

    # -- execution ---------------------------------------------------------

    def handle_message(self) -> None:
        arrival, _, sender_id, message, size = heapq.heappop(self.in_queue)
        self.time = max(self.time, arrival)
        self.message_count += 1
        self.message_size += size
        start = _time.perf_counter()
        step = self.algo.handle_message(sender_id, message)
        elapsed = _time.perf_counter() - start
        self.time += elapsed * 100.0 / self.hw.cpu_factor
        self._send_output_and_msgs(step, self.time)

    def handle_input(self, value) -> None:
        start = _time.perf_counter()
        step = self.algo.handle_input(value)
        elapsed = _time.perf_counter() - start
        self.time += elapsed * 100.0 / self.hw.cpu_factor
        self._send_output_and_msgs(step, self.time)

    def _send_output_and_msgs(self, step: Step, now: float) -> None:
        for out in step.output:
            self.outputs.append((now, out))
        self.sent_time = max(self.time, self.sent_time)
        for tm in step.messages:
            payload = dumps(tm.message)
            self.sent_time += self.hw.inv_bw * len(payload)
            self.out_queue.append(
                (self.sent_time + self.hw.latency, tm.target, tm.message, len(payload))
            )


class SimNetwork:
    """The virtual-time network (reference ``TestNetwork``,
    ``simulation.rs:258-344``).  ``ops`` is the backend every node
    shares (``core.network_info.resolve_ops``: the card's
    ``CudaBackend()`` when None)."""

    def __init__(
        self,
        num_nodes: int,
        num_dead: int,
        new_algo: Callable[[NetworkInfo], Any],
        hw: HwQuality,
        rng,
        mock_crypto: bool = True,
        ops: Any = None,
    ):
        netinfos = NetworkInfo.generate_map(
            list(range(num_nodes)), rng, mock=mock_crypto, ops=ops
        )
        self.rng = rng
        # extract crypto obligations at dispatch only when a batching
        # backend will consume them AND the crypto is real: under mock
        # crypto a prefetched share verifies in ~2 µs, cheaper than the
        # extraction walk and the cache, so the façade steps aside while
        # protocol decisions stay identical (the obligations would have
        # taken the per-item path anyway)
        self._collect_obs = (
            ops is not None and hasattr(ops, "prefetch") and not mock_crypto
        )
        self.nodes: Dict[Any, SimNode] = {}
        # lazy event heap: (next_event_time, seq, nid, ver).  Every
        # state change that can move a node's next event pushes a fresh
        # version-stamped entry; step() discards entries whose version
        # is no longer the node's latest — exactly one live entry per
        # node, O(log M) scheduling instead of a scan of all N nodes
        self._heap: List[Tuple[float, int, Any, int]] = []
        self._hseq = 0
        for nid in range(num_nodes):
            result = new_algo(netinfos[nid])
            algo, step = result if isinstance(result, tuple) else (result, None)
            # the last `num_dead` nodes are crashed from the start
            dead = nid >= num_nodes - num_dead
            self.nodes[nid] = SimNode(algo, step, hw, dead=dead)
        self._drain_out_queues()

    def _push_event(self, nid) -> None:
        node = self.nodes[nid]
        t = node.next_event_time()
        if t is not None:
            node.sched_ver += 1
            self._hseq += 1
            heapq.heappush(self._heap, (t, self._hseq, nid, node.sched_ver))

    def _drain_out_queues(self) -> None:
        msgs = []
        for node in self.nodes.values():
            for item in node.out_queue:
                msgs.append((node.id, item))
            node.out_queue.clear()
        for sender_id, (arrival, target, message, size) in msgs:
            self._dispatch(sender_id, arrival, target, message, size)

    def _drain_node(self, nid) -> None:
        """Dispatch only ``nid``'s pending sends (the only node whose
        out_queue can be non-empty after it handled one message)."""
        node = self.nodes[nid]
        if not node.out_queue:
            return
        items, node.out_queue = node.out_queue, []
        for arrival, target, message, size in items:
            self._dispatch(nid, arrival, target, message, size)

    def _dispatch(self, sender_id, arrival, target, message, size) -> None:
        if target.is_all:
            for nid, node in self.nodes.items():
                if nid != sender_id:
                    node.add_message(arrival, sender_id, message, size)
                    self._note_obs(node, sender_id, message)
                    self._push_event(nid)
        else:
            node = self.nodes.get(target.node)
            if node is not None:
                node.add_message(arrival, sender_id, message, size)
                self._note_obs(node, sender_id, message)
                self._push_event(target.node)

    def _note_obs(self, node: SimNode, sender_id, message) -> None:
        """Extract the message's crypto obligations once, at enqueue
        (obligations whose inputs are not known yet — e.g. a decryption
        share arriving before its ciphertext — verify inline later)."""
        if self._collect_obs and not node.dead:
            from .batching import crypto_obligations

            node.pending_obs.extend(
                crypto_obligations(node.algo, sender_id, message)
            )

    # -- batched crypto prefetch (harness/batching.py) ---------------------

    def queued_obligations(self) -> List[Any]:
        """Drain the share verifications extracted at enqueue."""
        obs: List[Any] = []
        for node in self.nodes.values():
            if node.pending_obs:
                obs.extend(node.pending_obs)
                node.pending_obs.clear()
        return obs

    def prefetch_crypto(self, backend) -> None:
        """Flush all currently-queued share verifications as one batch
        into ``backend``'s cache.  Protocol decisions are identical to
        the inline path; the virtual-time stats then measure the
        batched per-message cost."""
        backend.prefetch(self.queued_obligations())

    def step(self) -> Optional[Any]:
        """Advance the node with the earliest next event by one message.

        Lazy-heap scheduling: every mutation that can move a node's next
        event goes through ``_push_event``, which bumps the node's
        version stamp, so the entry carrying the node's current version
        is accurate and any other entry is discarded.  Equal-time heads
        are tie-broken with the scheduler RNG (``simulation.rs:313-324``),
        which is drawn only when 2+ heads tie at the same virtual time
        (float equality)."""
        while self._heap:
            t, _, nid, ver = heapq.heappop(self._heap)
            node = self.nodes[nid]
            if ver != node.sched_ver:
                continue  # dead entry (superseded)
            if node.next_event_time() is None:
                continue  # queue drained since this entry was pushed
            # collect live entries tied at the same time; rng picks
            ties = [nid]
            while self._heap and self._heap[0][0] == t:
                _, _, nid2, ver2 = heapq.heappop(self._heap)
                node2 = self.nodes[nid2]
                if ver2 == node2.sched_ver and node2.next_event_time() is not None:
                    ties.append(nid2)
            if len(ties) > 1:
                chosen = self.rng.choice(sorted(ties))
                for other in ties:
                    if other != chosen:
                        self._push_event(other)
            else:
                chosen = ties[0]
            node = self.nodes[chosen]
            node.handle_message()
            self._drain_node(chosen)
            self._push_event(chosen)
            return chosen
        return None

    def input(self, nid, value) -> None:
        self.nodes[nid].handle_input(value)
        self._drain_out_queues()
        # handle_input advanced the node's clock → refresh its entry
        self._push_event(nid)

    def message_count(self) -> int:
        return sum(n.message_count for n in self.nodes.values())

    def message_size(self) -> int:
        return sum(n.message_size for n in self.nodes.values())

    def live_nodes(self) -> List[SimNode]:
        return [n for n in self.nodes.values() if not n.dead]


@dataclasses.dataclass
class EpochRow:
    """One row of the per-epoch statistics table (reference
    ``EpochInfo::add``, ``simulation.rs:352-385``)."""

    epoch: int
    min_time: float
    max_time: float
    txs: int
    msgs_per_node: int
    bytes_per_node: int

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class EpochStats:
    # (field, title, format, value) per column: header and row rendering
    # consume the same spec
    _COLUMNS = (
        ("epoch", "Epoch", "{:>5}", lambda d: d["epoch"]),
        ("min_time", "MinTime", "{:>7.0f}ms", lambda d: d["min_time"] * 1000),
        ("max_time", "MaxTime", "{:>7.0f}ms", lambda d: d["max_time"] * 1000),
        ("txs", "Txs", "{:>5}", lambda d: d["txs"]),
        ("msgs_per_node", "Msgs/Node", "{:>9}", lambda d: d["msgs_per_node"]),
        ("bytes_per_node", "Size/Node", "{:>9}B", lambda d: d["bytes_per_node"]),
    )

    def __init__(self, network: SimNetwork):
        self.network = network
        self._per_epoch: Dict[int, Dict[Any, Tuple[float, Any]]] = {}
        self.rows: List[EpochRow] = []
        self._num_live = len(network.live_nodes())

    def add(self, nid, time: float, batch) -> Optional[EpochRow]:
        nodes = self._per_epoch.setdefault(batch.epoch, {})
        if nid in nodes:
            return None
        nodes[nid] = (time, batch)
        if len(nodes) < self._num_live:
            return None
        times = [t for t, _ in nodes.values()]
        txs = len(set(batch.tx_iter()))
        n = len(self.network.nodes)
        row = EpochRow(
            batch.epoch,
            min(times),
            max(times),
            txs,
            self.network.message_count() // n,
            self.network.message_size() // n,
        )
        self.rows.append(row)
        return row

    def rows_as_dicts(self) -> List[Dict[str, Any]]:
        return [r.as_dict() for r in self.rows]

    def committed_txs(self) -> set:
        """The transactions of every row's batch: what every live node
        has committed."""
        return {
            tx
            for r in self.rows
            for _, batch in self._per_epoch[r.epoch].values()
            for tx in batch.tx_iter()
        }

    def header(self) -> str:
        return f"{'Epoch':>5} {'MinTime':>8} {'MaxTime':>8} {'Txs':>5} {'Msgs/Node':>9} {'Size/Node':>10}"

    def format_row(self, row) -> str:
        """Render one row — an :class:`EpochRow` or its ``as_dict``
        form."""
        d = row.as_dict() if isinstance(row, EpochRow) else dict(row)
        return " ".join(fmt.format(value(d)) for _, _, fmt, value in self._COLUMNS)


def simulate_queueing_honey_badger(
    num_nodes: int = 10,
    num_dead: int = 0,
    num_txs: int = 1000,
    batch_size: int = 100,
    tx_size: int = 10,
    lag_ms: float = 100.0,
    bw_kbit_s: float = 2000.0,
    cpu_pct: float = 100.0,
    rng=None,
    mock_crypto: bool = True,
    ops: Any = None,
    verbose: bool = False,
    max_steps: int = 10_000_000,
):
    """Run the reference's headline benchmark scenario end to end:
    ``num_txs`` transactions through QueueingHoneyBadger on a simulated
    network.  ``ops``: the nodes' backend (the card's ``CudaBackend()``
    when None), or a ``BatchingBackend`` for batched share checks.
    Returns (EpochStats, wall_seconds, sim_seconds)."""
    from ..protocols.dynamic_honey_badger import DynamicHoneyBadger
    from ..protocols.queueing_honey_badger import QueueingHoneyBadger

    rng = rng if rng is not None else _random.Random(0)
    txs = [
        bytes(rng.randrange(256) for _ in range(tx_size))
        for _ in range(num_txs)
    ]

    def new_algo(netinfo):
        node_rng = _random.Random(f"sim-{netinfo.our_id}")
        dhb = DynamicHoneyBadger(netinfo, rng=node_rng)
        qhb, step = (
            QueueingHoneyBadger.builder(dhb)
            .batch_size(batch_size)
            .rng(node_rng)
            .build_with_transactions(list(txs))
        )
        return qhb, step

    hw = HwQuality.from_flags(lag_ms, bw_kbit_s, cpu_pct)
    net = SimNetwork(
        num_nodes, num_dead, new_algo, hw, rng, mock_crypto=mock_crypto, ops=ops
    )
    stats = EpochStats(net)
    all_txs = set(txs)
    committed: Dict[Any, set] = {n.id: set() for n in net.live_nodes()}
    seen_outputs: Dict[Any, int] = {n.id: 0 for n in net.live_nodes()}
    if verbose:
        print(stats.header())
    # batching backends get a prefetch pass every num_nodes steps: one
    # fused flush covers the round's queued share verifications
    # (disabled when the network skips obligation collection)
    prefetch_every = num_nodes if net._collect_obs else 0
    wall_start = _time.perf_counter()
    steps = 0
    while True:
        if prefetch_every and steps % prefetch_every == 0:
            net.prefetch_crypto(ops)
        nid = net.step()
        if nid is None:
            break
        steps += 1
        if steps > max_steps:
            raise RuntimeError("simulation step limit exceeded")
        node = net.nodes[nid]
        for t, batch in node.outputs[seen_outputs[nid] :]:
            row = stats.add(nid, t, batch)
            if row and verbose:
                print(stats.format_row(row))
            committed[nid].update(batch.tx_iter())
        seen_outputs[nid] = len(node.outputs)
        if all(c >= all_txs for c in committed.values()):
            break
    wall = _time.perf_counter() - wall_start
    sim_time = max((n.time for n in net.live_nodes()), default=0.0)
    return stats, wall, sim_time
