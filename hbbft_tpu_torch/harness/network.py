"""Adversarial in-process network simulator — the protocol test fixture.

The port's own copy of ``hbbft_tpu/harness/network.py`` (reference
``tests/network/mod.rs``): algorithms are sans-IO state machines, so a
dict of instances plus message queues *is* a network.  The adversary
controls scheduling (starvation forbidden), sees every message addressed
to corrupted nodes, and may inject arbitrary forged messages.  An
observer node (non-validator) exercises the observer code path.

All randomness flows from one seeded ``random.Random``: keys are dealt
from it first (``NetworkInfo.generate_map``), then the schedulers draw
from it, in the reference's order, so a run replays the reference's
step for step.  ``ops`` is the crypto backend every node shares; with
``ops=None`` it is the card's ``CudaBackend()`` (raises without CUDA),
``CudaBackend(device="cpu")`` runs the same route on the host.  Under a
backend with ``prefetch`` (``harness.batching.BatchingBackend``) the
network extracts each enqueued message's share checks
(``crypto_obligations``) and flushes them every n steps
(``prefetch_crypto``), the reference's cadence, so the flushes hold the
same shares as the reference's.  Checkpointing (pickling the network) is
not part of the port.
"""

from __future__ import annotations

import abc
import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.network_info import NetworkInfo, resolve_ops
from ..core.step import Step, Target, TargetedMessage


class TestNode:
    """A node running one algorithm instance (reference ``TestNode``,
    ``tests/network/mod.rs:16-81``)."""

    __test__ = False  # not a pytest class

    def __init__(self, algo, initial_step: Optional[Step] = None):
        self.id = algo.our_id()
        self.algo = algo
        self.queue: collections.deque = collections.deque()
        self.outputs: List[Any] = []
        self.messages: collections.deque = collections.deque()
        self.faults: List[Any] = []
        # crypto obligations extracted at enqueue, drained by the
        # batched prefetch (only populated under a batching backend)
        self.pending_obs: List[Any] = []
        if initial_step is not None:
            self._absorb(initial_step)

    def _absorb(self, step: Step) -> None:
        self.outputs.extend(step.output)
        self.messages.extend(step.messages)
        self.faults.extend(step.fault_log)

    def handle_input(self, value) -> None:
        self._absorb(self.algo.handle_input(value))

    def handle_message(self) -> None:
        sender_id, msg = self.queue.popleft()
        self._absorb(self.algo.handle_message(sender_id, msg))

    @property
    def is_idle(self) -> bool:
        return not self.queue

    def terminated(self) -> bool:
        return self.algo.terminated()

    @property
    def instance(self):
        return self.algo


class MessageScheduler:
    """Random / First scheduling strategies (reference ``:84-116``)."""

    RANDOM = "random"
    FIRST = "first"

    def __init__(self, kind: str, rng):
        assert kind in (self.RANDOM, self.FIRST)
        self.kind = kind
        self.rng = rng

    def pick_node(self, nodes: Dict[Any, TestNode]) -> Any:
        busy = [nid for nid, node in sorted(nodes.items()) if not node.is_idle]
        if not busy:
            raise RuntimeError("no more messages in any queue")
        if self.kind == self.FIRST:
            return busy[0]
        return self.rng.choice(busy)


class MessageWithSender:
    __slots__ = ("sender", "tm")

    def __init__(self, sender, tm: TargetedMessage):
        self.sender = sender
        self.tm = tm


class Adversary(abc.ABC):
    """Byzantine adversary API (reference ``tests/network/mod.rs:151-173``).

    Capabilities: (1) decide which node makes progress next (no
    starvation), (2) observe every message sent to corrupted nodes,
    (3) emit arbitrary messages originating from corrupted nodes.
    """

    def init(
        self,
        all_nodes: Dict[Any, TestNode],
        adv_netinfos: Dict[Any, NetworkInfo],
    ) -> None:
        pass

    @abc.abstractmethod
    def pick_node(self, nodes: Dict[Any, TestNode]) -> Any: ...

    @abc.abstractmethod
    def push_message(self, sender_id, tm: TargetedMessage) -> None: ...

    @abc.abstractmethod
    def step(self) -> List[MessageWithSender]: ...


class SilentAdversary(Adversary):
    """Corrupted nodes say nothing (reference ``:176-199``)."""

    def __init__(self, scheduler: MessageScheduler):
        self.scheduler = scheduler

    def pick_node(self, nodes):
        return self.scheduler.pick_node(nodes)

    def push_message(self, sender_id, tm):
        pass

    def step(self):
        return []


class RandomAdversary(Adversary):
    """Replay/injection fuzzer (reference ``:221-344``): unicasts to
    corrupted nodes are probabilistically re-sent to random recipients,
    and generator-produced garbage messages are injected."""

    def __init__(
        self,
        p_replay: float,
        p_inject: float,
        generator: Callable[[], TargetedMessage],
        rng,
    ):
        assert p_inject < 0.95, "injections repeat; p_inject must be < 0.95"
        self.p_replay = p_replay
        self.p_inject = p_inject
        self.generator = generator
        self.rng = rng
        self.scheduler = MessageScheduler(MessageScheduler.RANDOM, rng)
        self.known_node_ids: List[Any] = []
        self.known_adv_ids: List[Any] = []
        self.outgoing: List[MessageWithSender] = []

    def init(self, all_nodes, adv_netinfos):
        self.known_node_ids = sorted(all_nodes)
        self.known_adv_ids = sorted(adv_netinfos)

    def pick_node(self, nodes):
        return self.scheduler.pick_node(nodes)

    def push_message(self, sender_id, tm):
        if not self.known_node_ids:
            return
        if self.rng.random() > self.p_replay:
            return
        if tm.target.is_all:
            return
        # replay to a random (wrong) recipient, originating from the
        # corrupted original target
        new_target = self.rng.choice(self.known_node_ids)
        self.outgoing.append(
            MessageWithSender(
                tm.target.node, TargetedMessage(Target.to(new_target), tm.message)
            )
        )

    def step(self):
        out, self.outgoing = self.outgoing, []
        while self.rng.random() <= self.p_inject:
            if self.known_adv_ids:
                sender = self.rng.choice(self.known_adv_ids)
                out.append(MessageWithSender(sender, self.generator()))
        return out


class EquivocatingAdversary(Adversary):
    """Corrupted nodes send *conflicting* protocol messages to two
    disjoint halves of the honest nodes (the classic equivocation
    attack: Broadcast ``Value``/Agreement ``BVal`` splits), then fall
    silent.

    ``make_pair(adv_id) -> (msg_a, msg_b)`` builds the two conflicting
    messages; half A of the honest nodes (sorted order) receives
    ``msg_a``, half B ``msg_b``.  With f < N/3 equivocators the protocol
    guarantees all honest nodes still agree — scenario assertions
    compare their outputs bit-for-bit against a twin run in which the
    equivocators are simply dead.
    """

    def __init__(self, scheduler: MessageScheduler, make_pair):
        self.scheduler = scheduler
        self.make_pair = make_pair
        self.class_a: List[Any] = []
        self.class_b: List[Any] = []
        self.adv_ids: List[Any] = []
        self._emitted = False

    def init(self, all_nodes, adv_netinfos):
        honest = sorted(all_nodes)
        half = (len(honest) + 1) // 2
        self.class_a = honest[:half]
        self.class_b = honest[half:]
        self.adv_ids = sorted(adv_netinfos)

    def pick_node(self, nodes):
        return self.scheduler.pick_node(nodes)

    def push_message(self, sender_id, tm):
        pass

    def step(self):
        if self._emitted:
            return []
        self._emitted = True
        out: List[MessageWithSender] = []
        for adv in self.adv_ids:
            msg_a, msg_b = self.make_pair(adv)
            for nid in self.class_a:
                out.append(
                    MessageWithSender(
                        adv, TargetedMessage(Target.to(nid), msg_a)
                    )
                )
            for nid in self.class_b:
                out.append(
                    MessageWithSender(
                        adv, TargetedMessage(Target.to(nid), msg_b)
                    )
                )
        return out


class BadShareAdversary(Adversary):
    """Corrupted validators multicast forged threshold-decryption shares
    for the first ``epochs`` HoneyBadger epochs (generalizes the
    test-local ``FaultyShareAdversary``).  Honest nodes must verify each
    share, attribute ``INVALID_DECRYPTION_SHARE`` faults to the senders,
    and still commit the fault-free batch.  Mock-crypto networks only
    (the forged share type is :class:`~..crypto.mock.MockDecryptionShare`).
    """

    def __init__(self, scheduler: MessageScheduler, rng, epochs: int = 2):
        self.scheduler = scheduler
        self.rng = rng
        self.epochs = epochs
        self.all_ids: List[Any] = []
        self.adv_ids: List[Any] = []
        self._emitted = False

    def init(self, all_nodes, adv_netinfos):
        self.all_ids = sorted(all_nodes) + sorted(adv_netinfos)
        self.adv_ids = sorted(adv_netinfos)

    def pick_node(self, nodes):
        return self.scheduler.pick_node(nodes)

    def push_message(self, sender_id, tm):
        pass

    def step(self):
        if self._emitted:
            return []
        self._emitted = True
        from ..crypto.mock import MockDecryptionShare
        from ..protocols.honey_badger import (
            HbDecryptionShare,
            HoneyBadgerMessage,
        )

        out: List[MessageWithSender] = []
        for epoch in range(self.epochs):
            for adv in self.adv_ids:
                for proposer in self.all_ids:
                    bogus = MockDecryptionShare(
                        self.rng.randrange(2**256).to_bytes(32, "big"),
                        self.rng.randrange(2**256).to_bytes(32, "big"),
                    )
                    msg = HoneyBadgerMessage(
                        epoch, HbDecryptionShare(proposer, bogus)
                    )
                    out.append(
                        MessageWithSender(adv, TargetedMessage(Target.all(), msg))
                    )
        return out


# -- delivery schedules (message_filter callables) --------------------------
#
# Delay, reordering and partitions are *scheduler* power, not corruption:
# the asynchronous model lets the adversary hold any message finitely.
# These classes plug into ``TestNetwork(message_filter=...)`` and release
# their backlog through ``TestNetwork.release_held``.


class PartitionSchedule:
    """Deterministic network partition that heals.

    ``groups`` are disjoint collections of node ids; while the partition
    is active, any message crossing a group boundary is held.  The
    observer rides with ``groups[observer_side]``.  Call
    :meth:`heal` to dissolve the partition and flush the held backlog —
    liveness assertions then drive the network to completion.
    """

    def __init__(self, groups, observer_side: int = 0):
        self._side: Dict[Any, int] = {}
        for side, group in enumerate(groups):
            for nid in group:
                self._side[nid] = side
        self._side[TestNetwork.OBSERVER_ID] = observer_side
        self.healed = False
        self.held_count = 0

    def __call__(self, sender, recipient, message) -> bool:
        if self.healed:
            return True
        # ids outside every group (e.g. adversarial senders) are
        # reachable from either side
        a = self._side.get(sender)
        b = self._side.get(recipient)
        if a is None or b is None or a == b:
            return True
        self.held_count += 1
        return False

    def heal(self, network: "TestNetwork") -> None:
        """Dissolve the partition and deliver everything it held."""
        self.healed = True
        network.release_held()


class SeededDelaySchedule:
    """Seeded random delay + reordering.

    Each message is held with probability ``p_delay`` (all randomness
    from one ``random.Random(seed)`` — runs are reproducible).  Calling
    :meth:`pump` releases a random subset of the backlog, so held
    messages re-enter delivery out of their original send order.  Drain
    fully with ``network.release_held()`` once the scenario's delay
    budget is spent (delays must be finite for liveness).

    The draw itself is a pluggable seam: ``sampler(rng, sender,
    recipient, message, p_delay=...)`` returns the value compared
    against ``p_delay`` / ``p_release``.  The default consumes exactly
    one flat ``rng.random()`` per decision, as the reference's does.
    """

    def __init__(
        self, rng, p_delay: float = 0.25, p_release: float = 0.5, sampler=None
    ):
        self.rng = rng
        self.p_delay = p_delay
        self.p_release = p_release
        self.sampler = sampler
        self.held_count = 0

    def _draw(self, sender, recipient, message, threshold: float) -> float:
        if self.sampler is None:
            return self.rng.random()
        return self.sampler(
            self.rng, sender, recipient, message, p_delay=threshold
        )

    def __call__(self, sender, recipient, message) -> bool:
        if self._draw(sender, recipient, message, self.p_delay) < self.p_delay:
            self.held_count += 1
            return False
        return True

    def pump(self, network: "TestNetwork") -> None:
        """Release a random subset of the held backlog (reordered)."""
        network.release_held(
            lambda s, r, m: self._draw(s, r, m, self.p_release)
            < self.p_release
        )


class TestNetwork:
    """A network of ``TestNode`` with adversary-controlled scheduling
    (reference ``tests/network/mod.rs:359-541``).

    ``new_algo(netinfo) -> algo | (algo, Step)`` builds each node's
    instance; nodes ``0..good_num`` are honest, the next ``adv_num`` are
    adversarial, and one extra observer node (non-validator) receives
    every broadcast.
    """

    __test__ = False  # not a pytest class

    OBSERVER_ID = "observer"

    def __init__(
        self,
        good_num: int,
        adv_num: int,
        adversary_factory: Callable[[Dict[Any, NetworkInfo]], Adversary],
        new_algo: Callable[[NetworkInfo], Any],
        rng,
        mock_crypto: bool = True,
        ops: Any = None,
        message_filter: Optional[Callable[[Any, Any, Any], bool]] = None,
    ):
        n = good_num + adv_num
        ops = resolve_ops(ops)  # the card's CudaBackend() unless given
        netinfos = NetworkInfo.generate_map(
            list(range(n)), rng, mock=mock_crypto, ops=ops
        )
        self.rng = rng
        self.ops = ops
        # ``message_filter(sender, recipient, message) -> deliver?``:
        # the asynchronous network model lets the adversary delay any
        # message arbitrarily (but finitely); a False verdict holds the
        # message in ``held_messages`` until ``release_held()``.  This
        # is scheduler power (delaying), not corruption — the reference
        # models it through adversarial scheduling of its queues.
        self.message_filter = message_filter
        self.held_messages: List[Tuple[Any, Any, Any]] = []
        # crash plane: nodes killed via ``kill()``; messages addressed
        # to a down node buffer here (the in-memory analogue of the TCP
        # transport's replay buffer) and are redelivered on restart
        self._down: Dict[Any, List[Tuple[Any, Any]]] = {}
        # batching backends get a prefetch pass every ~n steps
        self.prefetch_every = n if hasattr(ops, "prefetch") else 0
        self._steps = 0
        self.adv_netinfos = {i: netinfos[i] for i in range(good_num, n)}
        obs_netinfo = netinfos[0].observer_view(self.OBSERVER_ID)

        def build(ni):
            result = new_algo(ni)
            if isinstance(result, tuple):
                return TestNode(result[0], result[1])
            return TestNode(result)

        self.nodes: Dict[Any, TestNode] = {
            i: build(netinfos[i]) for i in range(good_num)
        }
        self.observer = build(obs_netinfo)
        self.adversary = adversary_factory(self.adv_netinfos)
        self.adversary.init(self.nodes, self.adv_netinfos)

        for mws in self.adversary.step():
            self.dispatch_messages(mws.sender, [mws.tm])
        for nid in sorted(self.nodes):
            node = self.nodes[nid]
            msgs = list(node.messages)
            node.messages.clear()
            self.dispatch_messages(nid, msgs)

    # ------------------------------------------------------------------

    def _enqueue(self, recipient, node, sender_id, message) -> None:
        """Deliver to one queue unless the delay filter holds it."""
        if self.message_filter is not None and not self.message_filter(
            sender_id, recipient, message
        ):
            self.held_messages.append((sender_id, recipient, message))
            return
        node.queue.append((sender_id, message))
        if node is not self.observer:
            self._note_obs(node, sender_id, message)

    def release_held(self, predicate=None) -> None:
        """Deliver held messages (the adversary's delays are finite;
        call this to model their eventual arrival).  ``predicate(sender,
        recipient, message)`` releases only the matching subset — the
        staged-wave schedules of the partition adversaries (divergent-
        view tests) release one wave at a time."""
        if predicate is None:
            held, self.held_messages = self.held_messages, []
        else:
            held, kept = [], []
            for m in self.held_messages:  # one predicate call per message
                (held if predicate(*m) else kept).append(m)
            self.held_messages = kept
        for sender_id, recipient, message in held:
            if recipient in self._down:
                self._down[recipient].append((sender_id, message))
                continue
            node = (
                self.observer
                if recipient == self.OBSERVER_ID
                else self.nodes[recipient]
            )
            node.queue.append((sender_id, message))
            if node is not self.observer:
                self._note_obs(node, sender_id, message)
        # the observer normally drains inside dispatch_messages; the
        # released copies must not strand in its queue
        while self.observer.queue:
            self.observer.handle_message()
            assert not self.observer.messages, (
                "observer attempted to send messages"
            )

    def dispatch_messages(self, sender_id, msgs) -> None:
        """Route messages to queues; observer drains synchronously
        (reference ``:447-481``)."""
        for tm in msgs:
            if tm.target.is_all:
                for nid, node in self.nodes.items():
                    if nid != sender_id:
                        self._enqueue(nid, node, sender_id, tm.message)
                for nid in self._down:
                    if nid != sender_id:
                        self._down[nid].append((sender_id, tm.message))
                self._enqueue(
                    self.OBSERVER_ID, self.observer, sender_id, tm.message
                )
                self.adversary.push_message(sender_id, tm)
            else:
                to_id = tm.target.node
                if to_id in self.adv_netinfos:
                    self.adversary.push_message(sender_id, tm)
                elif to_id in self.nodes:
                    self._enqueue(to_id, self.nodes[to_id], sender_id, tm.message)
                elif to_id in self._down:
                    self._down[to_id].append((sender_id, tm.message))
                elif to_id == self.OBSERVER_ID:
                    self._enqueue(
                        self.OBSERVER_ID, self.observer, sender_id, tm.message
                    )
                # unknown recipients are dropped (reference warns only)
        while self.observer.queue:
            self.observer.handle_message()
            msgs_obs = list(self.observer.messages)
            self.observer.messages.clear()
            # observers are not validators; they send nothing, but if an
            # algorithm misbehaves we surface it rather than hide it
            assert not msgs_obs, "observer attempted to send messages"

    # -- crash / restart ---------------------------------------------------

    def kill(self, nid) -> TestNode:
        """SIGKILL-sim: remove a node mid-run.  Its received-but-not-
        yet-applied queue moves to the down-buffer (in a real deployment
        those frames sit in peers' replay buffers — they were never
        applied, so the WAL does not have them either) and every later
        message addressed to it buffers until :meth:`restart`."""
        node = self.nodes.pop(nid)
        self._down[nid] = list(node.queue)
        node.queue.clear()
        return node

    def restart(self, nid, node) -> TestNode:
        """Rejoin a restarted node (a recovered algorithm or a
        ``TestNode`` wrapping one): redeliver everything buffered while
        it was down, in arrival order — the in-memory equivalent of the
        TCP resume replay."""
        if not isinstance(node, TestNode):
            node = TestNode(node)
        buffered = self._down.pop(nid, [])
        self.nodes[nid] = node
        for sender_id, message in buffered:
            node.queue.append((sender_id, message))
            self._note_obs(node, sender_id, message)
        return node

    # -- checkpointing -----------------------------------------------------

    def __getstate__(self):
        raise TypeError(
            "pickling a TestNetwork (checkpointing) is not part of the port"
        )

    # -- batched crypto prefetch (harness/batching.py) ---------------------

    def _note_obs(self, node: TestNode, sender_id, message) -> None:
        """Extract the message's crypto obligations once, at enqueue
        (re-scanning queues at every flush is quadratic)."""
        if self.prefetch_every:
            from .batching import crypto_obligations

            node.pending_obs.extend(
                crypto_obligations(node.algo, sender_id, message)
            )

    def prefetch_crypto(self) -> None:
        """Flush the enqueued share verifications as one batch into the
        backend's cache (bit-identical outcomes, see
        ``harness/batching.py``)."""
        obs = []
        for node in self.nodes.values():
            if node.pending_obs:
                obs.extend(node.pending_obs)
                node.pending_obs.clear()
        self.ops.prefetch(obs)

    def step(self) -> Any:
        """One network iteration: adversary injects, then the adversary
        picks one non-idle honest node to handle one message
        (reference ``:490-518``)."""
        if self.prefetch_every:
            if self._steps % self.prefetch_every == 0:
                self.prefetch_crypto()
            self._steps += 1
        for mws in self.adversary.step():
            self.dispatch_messages(mws.sender, [mws.tm])
        nid = self.adversary.pick_node(self.nodes)
        node = self.nodes[nid]
        assert not node.is_idle, "adversary illegally picked an idle node"
        node.handle_message()
        msgs = list(node.messages)
        node.messages.clear()
        self.dispatch_messages(nid, msgs)
        return nid

    def input(self, nid, value) -> None:
        node = self.nodes[nid]
        node.handle_input(value)
        msgs = list(node.messages)
        node.messages.clear()
        self.dispatch_messages(nid, msgs)

    def input_all(self, value) -> None:
        for nid in sorted(self.nodes):
            self.input(nid, value)

    # -- helpers for test predicates --------------------------------------

    def any_busy(self) -> bool:
        return any(not n.is_idle for n in self.nodes.values())

    def step_until(self, predicate, max_steps: int = 1_000_000) -> None:
        steps = 0
        while not predicate():
            if not self.any_busy():
                raise RuntimeError(
                    "network went idle before predicate was satisfied"
                )
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("step limit exceeded")
