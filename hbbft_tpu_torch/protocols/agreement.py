"""Binary Byzantine Agreement (ABA) — Mostéfaoui-Moumen-Raynal style.

The port's own copy of ``hbbft_tpu/protocols/agreement.py`` (reference
``src/agreement/``).  Each node inputs a bool; all correct nodes output
the same bool, which was input by at least one correct node.  Per epoch:

1. SBV-Broadcast the estimate (BVal/Aux thresholds f+1 / 2f+1 / N−f);
2. before a *real* coin epoch, a ``Conf`` round fixes candidate values
   (finishes at N−f Confs ⊆ bin_values);
3. obtain the coin: epochs ≡ 0 mod 3 → true, ≡ 1 mod 3 → false,
   ≡ 2 mod 3 → threshold-signature CommonCoin;
4. unique candidate == coin ⇒ decide and broadcast ``Term``; otherwise
   next epoch with estimate = candidate or coin.

``Term(b)`` counts as BVal+Aux+Conf for all future epochs and enables
expedited termination at f+1 Terms.  Future-epoch messages are queued;
expired non-Term messages are dropped.  ``random_message`` draws garbage
messages for fuzzing adversaries (mock coin shares).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..core.algorithm import DistAlgorithm, HbbftError
from ..core.fault import FaultKind
from ..core.network_info import NetworkInfo
from ..core.serialize import wire
from ..core.fault import log as _log
from ..core.step import Step
from .bool_set import BoolMultimap, BoolSet
from .common_coin import CommonCoin, CommonCoinMessage, make_nonce
from .sbv_broadcast import Aux, BVal, SbvBroadcast


# -- messages ---------------------------------------------------------------


@wire("AbaSbv")
@dataclasses.dataclass(frozen=True)
class SbvContent:
    msg: Any  # BVal | Aux


@wire("AbaConf")
@dataclasses.dataclass(frozen=True)
class ConfContent:
    values: BoolSet


@wire("AbaTerm")
@dataclasses.dataclass(frozen=True)
class TermContent:
    value: bool


@wire("AbaCoin")
@dataclasses.dataclass(frozen=True)
class CoinContent:
    msg: CommonCoinMessage


@wire("AbaMsg")
@dataclasses.dataclass(frozen=True)
class AgreementMessage:
    epoch: int
    content: Any

    def can_expire(self) -> bool:
        return not isinstance(self.content, TermContent)


class InputNotAccepted(HbbftError):
    pass


class UnknownProposer(HbbftError):
    pass


# -- coin state -------------------------------------------------------------


class _CoinState:
    """Fixed coin value, or an in-progress CommonCoin instance."""

    __slots__ = ("decided", "coin")

    def __init__(self, decided: Optional[bool], coin: Optional[CommonCoin]):
        self.decided = decided
        self.coin = coin

    @classmethod
    def fixed(cls, value: bool) -> "_CoinState":
        return cls(value, None)

    @classmethod
    def in_progress(cls, coin: CommonCoin) -> "_CoinState":
        return cls(None, coin)

    def value(self) -> Optional[bool]:
        return self.decided


class Agreement(DistAlgorithm):
    def __init__(self, netinfo: NetworkInfo, session_id: int, proposer_id):
        if not netinfo.is_node_validator(proposer_id):
            raise UnknownProposer(f"unknown proposer {proposer_id!r}")
        self.netinfo = netinfo
        self.session_id = session_id
        self.proposer_id = proposer_id
        self.epoch = 0
        self.sbv_broadcast = SbvBroadcast(netinfo)
        self.received_conf: Dict[Any, BoolSet] = {}
        self.received_term = BoolMultimap()
        self.estimated: Optional[bool] = None
        self.decision: Optional[bool] = None
        self.incoming_queue: Dict[int, List[Tuple[Any, Any]]] = {}
        self.conf_values: Optional[BoolSet] = None
        self.coin_state = _CoinState.fixed(True)  # epoch 0 coin is true

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, value: bool) -> Step:
        if self.epoch != 0 or self.estimated is not None:
            raise InputNotAccepted("input only accepted in epoch 0")
        self.estimated = bool(value)
        sbvb_step = self.sbv_broadcast.handle_input(bool(value))
        return self._handle_sbvb_step(sbvb_step)

    def accepts_input(self) -> bool:
        return self.epoch == 0 and self.estimated is None

    def handle_message(self, sender_id, message) -> Step:
        if not isinstance(message, AgreementMessage):
            return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
        # epoch arrives off the wire: a non-int would raise in the
        # comparisons / queue keying below instead of being attributed
        if not isinstance(message.epoch, int) or isinstance(message.epoch, bool):
            return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
        if self.decision is not None or (
            message.epoch < self.epoch and message.can_expire()
        ):
            return Step()  # obsolete
        if message.epoch > self.epoch:
            # queue for later (reference ``agreement.rs:95-99``)
            self.incoming_queue.setdefault(message.epoch, []).append(
                (sender_id, message.content)
            )
            return Step()
        return self._handle_content(sender_id, message.content)

    def terminated(self) -> bool:
        return self.decision is not None

    def our_id(self):
        return self.netinfo.our_id

    # -- dispatch ----------------------------------------------------------

    def _handle_content(self, sender_id, content) -> Step:
        if isinstance(content, SbvContent):
            sbvb_step = self.sbv_broadcast.handle_message(
                sender_id, content.msg
            )
            return self._handle_sbvb_step(sbvb_step)
        if isinstance(content, ConfContent):
            if not isinstance(content.values, BoolSet):
                return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
            return self._handle_conf(sender_id, content.values)
        if isinstance(content, TermContent):
            if not isinstance(content.value, bool):
                return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
            return self._handle_term(sender_id, content.value)
        if isinstance(content, CoinContent):
            return self._handle_coin(sender_id, content.msg)
        return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)

    def _handle_sbvb_step(self, sbvb_step) -> Step:
        step: Step = Step()
        epoch = self.epoch
        output = step.extend_with(
            sbvb_step,
            lambda m: AgreementMessage(epoch, SbvContent(m)),
        )
        if self.conf_values is not None:
            return step  # Conf round already started
        for aux_vals in output[:1]:
            if self.coin_state.decided is not None:
                self.conf_values = aux_vals
                step.extend(self._try_update_epoch())
            else:
                step.extend(self._send_conf(aux_vals))
        return step

    # -- Conf round --------------------------------------------------------

    def _handle_conf(self, sender_id, values: BoolSet) -> Step:
        if sender_id in self.received_conf:
            return Step.from_fault(sender_id, FaultKind.DUPLICATE_CONF)
        self.received_conf[sender_id] = values
        return self._try_finish_conf_round()

    def _send_conf(self, values: BoolSet) -> Step:
        if self.conf_values is not None:
            return Step()
        self.conf_values = values
        if not self.netinfo.is_validator:
            return self._try_finish_conf_round()
        return self._send(ConfContent(values))

    def _try_finish_conf_round(self) -> Step:
        if self.conf_values is None or self._count_conf() < self.netinfo.num_correct:
            return Step()
        if self.coin_state.coin is None:
            return Step()  # coin already decided
        coin_step = self.coin_state.coin.handle_input()
        step = self._on_coin_step(coin_step)
        step.extend(self._try_update_epoch())
        return step

    def _count_conf(self) -> int:
        bv = self.sbv_broadcast.bin_values
        return sum(
            1 for c in self.received_conf.values() if c.is_subset(bv)
        )

    # -- Term --------------------------------------------------------------

    def _handle_term(self, sender_id, b: bool) -> Step:
        if sender_id in self.received_term[b]:
            return Step.from_fault(sender_id, FaultKind.DUPLICATE_TERM)
        self.received_term[b].add(sender_id)
        if self.decision is not None:
            return Step()
        if len(self.received_term[b]) > self.netinfo.num_faulty:
            return self._decide(b)  # expedited termination
        # count as BVal + Aux + Conf
        sbvb_step = self.sbv_broadcast.handle_bval(sender_id, b)
        sbvb_step.extend(self.sbv_broadcast.handle_aux(sender_id, b))
        step = self._handle_sbvb_step(sbvb_step)
        step.extend(self._handle_conf(sender_id, BoolSet.single(b)))
        return step

    # -- coin --------------------------------------------------------------

    def _handle_coin(self, sender_id, msg: CommonCoinMessage) -> Step:
        if self.coin_state.coin is None:
            return Step()  # already decided
        coin_step = self.coin_state.coin.handle_message(sender_id, msg)
        return self._on_coin_step(coin_step)

    def _on_coin_step(self, coin_step) -> Step:
        step: Step = Step()
        epoch = self.epoch
        coin_output = step.extend_with(
            coin_step,
            lambda m: AgreementMessage(epoch, CoinContent(m)),
        )
        for coin in coin_output[:1]:
            self.coin_state = _CoinState.fixed(bool(coin))
            step.extend(self._try_update_epoch())
        return step

    def _coin_state_for_epoch(self) -> _CoinState:
        m = self.epoch % 3
        if m == 0:
            return _CoinState.fixed(True)
        if m == 1:
            return _CoinState.fixed(False)
        nonce = make_nonce(
            self.netinfo.invocation_id(),
            self.session_id,
            self.netinfo.node_index(self.proposer_id),
            self.epoch,
        )
        return _CoinState.in_progress(CommonCoin(self.netinfo, nonce))

    # -- epoch transitions -------------------------------------------------

    def _try_update_epoch(self) -> Step:
        if self.decision is not None:
            return Step()
        coin = self.coin_state.value()
        if coin is None:
            return Step()
        if self.conf_values is None:
            return Step()
        def_bin = self.conf_values.definite()
        if def_bin is not None and def_bin == coin:
            return self._decide(coin)
        return self._update_epoch(def_bin if def_bin is not None else coin)

    def _decide(self, b: bool) -> Step:
        if self.decision is not None:
            return Step()
        self.decision = b
        _log.debug(
            "%r: agreement on %r decided %s at epoch %d",
            self.netinfo.our_id, self.proposer_id, b, self.epoch,
        )
        step = Step.with_output(b)
        if self.netinfo.is_validator:
            step.send_all(AgreementMessage(self.epoch + 1, TermContent(b)))
        return step

    def _update_epoch(self, b: bool) -> Step:
        self.sbv_broadcast.clear(self.received_term)
        self.received_conf = {
            nid: BoolSet.single(v) for v, nid in self.received_term
        }
        self.conf_values = None
        self.epoch += 1
        self.coin_state = self._coin_state_for_epoch()
        self.estimated = b
        sbvb_step = self.sbv_broadcast.handle_input(b)
        step = self._handle_sbvb_step(sbvb_step)
        for sender_id, content in self.incoming_queue.pop(self.epoch, []):
            step.extend(self._handle_content(sender_id, content))
            if self.decision is not None:
                break
        return step

    # -- messaging ---------------------------------------------------------

    def _send(self, content) -> Step:
        if not self.netinfo.is_validator:
            return Step()
        step: Step = Step()
        step.send_all(AgreementMessage(self.epoch, content))
        step.extend(self._handle_content(self.netinfo.our_id, content))
        return step


def random_message(rng):
    """Garbage agreement message for fuzz adversaries (reference
    ``agreement/mod.rs:137-149``)."""
    epoch = rng.randrange(3)
    kind = rng.randrange(4)
    if kind == 0:
        inner = BVal(bool(rng.randrange(2))) if rng.randrange(2) else Aux(
            bool(rng.randrange(2))
        )
        return AgreementMessage(epoch, SbvContent(inner))
    if kind == 1:
        return AgreementMessage(epoch, ConfContent(BoolSet(rng.randrange(4))))
    if kind == 2:
        return AgreementMessage(epoch, TermContent(bool(rng.randrange(2))))
    from ..crypto.mock import MockSignatureShare

    share = MockSignatureShare(
        rng.randrange(2**256).to_bytes(32, "big"),
        rng.randrange(2**256).to_bytes(32, "big"),
    )
    return AgreementMessage(epoch, CoinContent(CommonCoinMessage(share)))
