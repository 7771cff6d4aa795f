"""The port's core runtime against the reference's.

``core/step.py``, ``core/fault.py``, ``core/algorithm.py`` and the
``NetworkInfo`` pieces the sequential engines use, next to
``hbbft_tpu/core``: Step combinators, every ``FaultKind`` by name, text
and order, the per-node default rng stream, and the ``@wire`` registry
(every type the port registers has the reference's wire name and field
layout, so ``dumps`` gives the same bytes in both packages).  Tolerance
is 0 throughout.
"""

import dataclasses
import importlib
import importlib.util
import pkgutil
import random

import pytest

from torch_twin import PORT, REF, twin


def test_target_and_message_map():
    S = PORT.step
    assert S.Target.all().is_all and not S.Target.to(3).is_all
    assert S.Target.to(3) == S.Target.to(3) != S.Target.to(4)
    with pytest.raises(ValueError):
        S.Target.to(None)
    tm = S.Target.to(1).message(("Echo", b"x")).map(lambda m: ("Wrapped", m))
    assert tm.target == S.Target.to(1)
    assert tm.message == ("Wrapped", ("Echo", b"x"))


def _step_combinators(side):
    S, K = side.step.Step, side.fault.FaultKind
    child = S(output=["out"])
    child.send_all("inner")
    child.add_fault(9, K.INVALID_PROOF)
    parent = S()
    outputs = parent.extend_with(child, lambda m: ("wrap", m))
    a = S(output=[1])
    b = S(output=[2])
    b.send_to(5, "m")
    a.extend(b)
    fl = side.fault.FaultLog.init(1, K.DUPLICATE_BVAL)
    fl.merge(side.fault.FaultLog.init(2, K.DUPLICATE_AUX))
    return {
        "outputs": outputs,
        "wrapped": [(tm.target.node, tm.message) for tm in parent.messages],
        "faults": [f.compact() for f in parent.fault_log],
        "merged": (a.output, [(tm.target.node, tm.message) for tm in a.messages]),
        "empty": (S().is_empty(), S.with_output(1).is_empty(), S.from_fault(1, K.MULTIPLE_ECHOS).is_empty()),
        "log": [f.compact() for f in fl],
    }


def test_step_combinators_match_reference():
    twin(_step_combinators)


def test_every_fault_kind_in_the_reference_order():
    ref = [(k.name, k.value) for k in REF.fault.FaultKind]
    port = [(k.name, k.value) for k in PORT.fault.FaultKind]
    assert port == ref
    assert len(port) == 29


def test_dist_algorithm_leaves_checkpointing_out():
    A = PORT.algorithm
    assert issubclass(A.CryptoError, A.HbbftError)
    assert issubclass(A.UnknownSenderError, A.HbbftError)
    for name in ("state_digest", "snapshot", "restore"):
        assert hasattr(REF.algorithm.DistAlgorithm, name)
        assert not hasattr(A.DistAlgorithm, name)


@pytest.mark.parametrize("mock", [True, False], ids=["mock", "real"])
def test_default_rng_streams_match_reference(mock):
    def streams(side):
        nis = side.ni.NetworkInfo.generate_map(range(4), random.Random(5), mock=mock, ops=side.ops())
        obs = nis[0].observer_view("observer")
        return [
            [ni.default_rng(label).getrandbits(64) for label in ("", "honey_badger")]
            for ni in list(nis.values()) + [obs]
        ]

    twin(streams)


def test_network_info_topology():
    rng = random.Random(1)
    for n, f in [(1, 0), (2, 0), (3, 0), (4, 1), (7, 2), (10, 3)]:
        nis = PORT.ni.NetworkInfo.generate_map(range(n), rng, mock=True, ops=PORT.ops())
        ni = nis[n - 1]
        assert (ni.num_nodes, ni.num_faulty, ni.num_correct) == (n, f, n - f)
        assert ni.node_index(n - 1) == n - 1 and ni.is_validator
        assert ni.invocation_id() == nis[0].invocation_id()
        obs = ni.observer_view("observer")
        assert not obs.is_validator and obs.our_index is None
        assert obs.public_key_share(0) is not None


def test_wire_registry_matches_reference():
    """Every wire type of the port, next to the reference module of the
    same path: same wire name, same class name, same fields."""
    import hbbft_tpu_torch

    for m in pkgutil.walk_packages(hbbft_tpu_torch.__path__, "hbbft_tpu_torch."):
        importlib.import_module(m.name)
        ref_name = "hbbft_tpu" + m.name[len("hbbft_tpu_torch"):]
        if importlib.util.find_spec(ref_name) is not None:
            importlib.import_module(ref_name)
    ref, port = REF.ser, PORT.ser
    names = sorted(port._BY_NAME)
    for name in ("BoolSet", "BcValue", "AbaMsg", "CsBc", "HbMsg", "DkgPart", "DhbHb", "BivarCommitment"):
        assert name in names
    for name in names:
        assert name in ref._BY_NAME, name
        pcls, rcls = port._BY_NAME[name][0], ref._BY_NAME[name][0]
        assert pcls.__name__ == rcls.__name__, name
        if dataclasses.is_dataclass(rcls):
            assert [f.name for f in dataclasses.fields(pcls)] == [
                f.name for f in dataclasses.fields(rcls)
            ], name
    assert len({v[0] for v in port._BY_CLASS.values()}) == len(port._BY_CLASS)
