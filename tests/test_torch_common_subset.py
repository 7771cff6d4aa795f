"""The port's asynchronous common subset against the reference's.

The scenarios of ``tests/test_common_subset.py`` and the validation case
of ``tests/test_adversarial.py``, run through the reference and the port
(``ops=CudaBackend(device="cpu")``) from one seed: step sequences,
outputs by ``dumps`` bytes and fault logs identical (tolerance 0); every
correct node and the observer output one identical subset of ≥ N−f
proposals, each entry its proposer's input.
"""

import random

import pytest

from torch_twin import PORT, twin


def _run(side, seed, size, proposals, mock=True):
    rng = random.Random(seed)
    f = (size - 1) // 3
    net = side.network(
        size - f, f, side.silent(rng), lambda ni: side.cs.CommonSubset(ni, 0), rng, mock_crypto=mock
    )
    for nid, value in sorted(proposals.items()):
        if nid in net.nodes:
            net.input(nid, value)
    net.step_until(lambda: all(n.outputs for n in net.nodes.values()))
    first = net.nodes[0].outputs[0]
    for node in list(net.nodes.values()) + [net.observer]:
        assert node.outputs == [first]
    assert all(proposals.get(pid) == value for pid, value in first.items())
    assert len(first) >= size - f
    return net


@pytest.mark.parametrize("size", [1, 2, 4, 7])
def test_all_propose_matches_reference(size):
    twin(_run, 30 + size, size, {i: b"value-%d" % i for i in range(size)})


def test_3_out_of_4_matches_reference():
    ref, port = twin(_run, 31, 4, {0: b"A", 1: b"B", 2: b"C"})
    assert set(port.nodes[0].outputs[0]) <= {0, 1, 2}


def test_5_distinct_values_match_reference():
    twin(_run, 32, 5, {i: bytes([65 + i]) * (i + 1) for i in range(5)})


def test_real_bls_matches_reference():
    twin(_run, 34, 4, {i: b"real-%d" % i for i in range(4)}, mock=False)


def test_completion_output_order_is_arrival_independent():
    ni = PORT.ni.NetworkInfo.generate_map(range(4), random.Random(7), mock=True, ops=PORT.ops())[0]
    outs = []
    for order in ([0, 1, 2, 3], [3, 1, 0, 2]):
        cs = PORT.cs.CommonSubset(ni, 0)
        for pid in order:
            cs.broadcast_results[pid] = bytes([pid])
            cs.agreement_results[pid] = True
        outs.append(cs._try_agreement_completion())
    assert outs[0] == outs[1] and list(outs[0]) == [0, 1, 2, 3]


def _rejects(side):
    A, C = side.ag, side.cs
    ni = side.ni.NetworkInfo.generate_map(range(4), random.Random(0xAD), mock=True, ops=side.ops())[0]
    cs = C.CommonSubset(ni, 0)
    out = []
    for proposer in ([1], {"a": 1}, "ghost", 42):
        for msg in (
            C.CsBroadcast(proposer, "m"),
            C.CsAgreement(proposer, A.AgreementMessage(0, A.TermContent(True))),
        ):
            step = cs.handle_message(1, msg)
            kinds = {f.kind.name for f in step.fault_log}
            assert kinds and kinds <= {"INVALID_MESSAGE", "UNEXPECTED_PROPOSER"}
            out.append([f.compact() for f in step.fault_log])
    out.append([f.compact() for f in cs.handle_message(2, "junk").fault_log])
    return out


def test_common_subset_rejects_bad_proposers():
    twin(_rejects)
