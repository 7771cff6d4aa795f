"""The port's binary agreement stack against the reference's.

``protocols/bool_set.py``, ``sbv_broadcast.py``, ``common_coin.py`` and
``agreement.py``: the scenarios of ``tests/test_agreement.py`` and
``tests/test_common_coin.py`` and the validation cases of
``tests/test_adversarial.py``, each run through the reference and the
port (``ops=CudaBackend(device="cpu")``) from one seed.  Step sequences,
outputs by ``dumps`` bytes and fault logs must be identical (tolerance
0); real BLS only at N ≤ 4, where the coin's threshold signature shares
go through ``verify_sig_share``.
"""

import random

import pytest

from torch_twin import PORT, twin


def _bool_sets(side):
    B = side.bool_set
    out = []
    for a in range(4):
        s = B.BoolSet(a)
        row = [sorted(s), len(s), s.definite(), True in s, False in s, s.copy() == s]
        for b in range(4):
            row.append(s.is_subset(B.BoolSet(b)))
        t = s.copy()
        row += [t.insert(True), t.insert(False), t.bits]
        out.append((s, row))
    m = B.BoolMultimap()
    m[True].update({3, 1})
    m[False].add(2)
    out.append(list(m.copy()))
    out.append([B.BoolSet.none(), B.BoolSet.both(), B.BoolSet.single(True), B.BoolSet.single(False)])
    return out


def test_bool_set_matches_reference():
    twin(_bool_sets)
    with pytest.raises(ValueError):
        PORT.bool_set.BoolSet(4)


def _invalid_kinds(step):
    kinds = [f.kind.name for f in step.fault_log]
    assert kinds and set(kinds) <= {"INVALID_MESSAGE", "UNEXPECTED_PROPOSER"}, kinds
    return [f.compact() for f in step.fault_log]


def _netinfos(side, n=4, seed=0xAD):
    return side.ni.NetworkInfo.generate_map(range(n), random.Random(seed), mock=True, ops=side.ops())


def _sbv_rejects(side):
    S = side.sbv
    return [
        _invalid_kinds(S.SbvBroadcast(_netinfos(side)[0]).handle_message(1, content))
        for content in (S.BVal(2), S.BVal("t"), S.Aux(None), S.Aux([True]), "junk")
    ]


def test_sbv_broadcast_rejects_non_bool_votes():
    twin(_sbv_rejects)


def _sbv_duplicates(side):
    """Duplicate BVal/Aux are attributed; 2f+1 BVals fill bin_values."""
    S = side.sbv
    sbv = S.SbvBroadcast(_netinfos(side)[0])
    steps = [sbv.handle_input(True)]
    for sender in (1, 1, 2, 3):
        steps.append(sbv.handle_message(sender, S.BVal(True)))
    for sender in (1, 2, 2, 3):
        steps.append(sbv.handle_message(sender, S.Aux(True)))
    return {
        "faults": [[f.compact() for f in st.fault_log] for st in steps],
        "outputs": [st.output for st in steps],
        "messages": [[tm.message for tm in st.messages] for st in steps],
        "bin_values": sbv.bin_values,
        "terminated": sbv.terminated(),
    }


def test_sbv_broadcast_thresholds_match_reference():
    twin(_sbv_duplicates)


def _agreement_rejects(side):
    A = side.ag
    ag = A.Agreement(_netinfos(side)[0], 0, 1)
    out = [
        _invalid_kinds(ag.handle_message(1, A.AgreementMessage(False, "x"))),
        _invalid_kinds(ag.handle_message(1, A.AgreementMessage(0, A.ConfContent("not-a-boolset")))),
        _invalid_kinds(ag.handle_message(1, A.AgreementMessage(0, A.TermContent("not-a-bool")))),
        _invalid_kinds(ag.handle_message(1, "not-a-message")),
    ]
    with pytest.raises(A.UnknownProposer):
        A.Agreement(_netinfos(side)[0], 0, 99)
    return out


def test_agreement_rejects_non_int_epoch_and_confused_contents():
    twin(_agreement_rejects)


def test_agreement_rejects_late_input():
    A = PORT.ag
    ag = A.Agreement(_netinfos(PORT)[0], 0, 0)
    ag.handle_input(True)
    assert not ag.accepts_input()
    with pytest.raises(A.InputNotAccepted):
        ag.handle_input(False)


def _run_agreement(side, seed, sizes, inputs, mock=True, kind="random", trials=1):
    rng = random.Random(seed)
    nets = {}
    for size in sizes:
        for trial in range(trials):
            f = (size - 1) // 3
            net = side.network(
                size - f, f, side.silent(rng, kind), lambda ni: side.ag.Agreement(ni, 0, 0), rng,
                mock_crypto=mock,
            )
            for nid in sorted(net.nodes):
                net.input(nid, inputs if inputs is not None else bool(rng.randrange(2)))
            net.step_until(lambda: all(n.terminated() for n in net.nodes.values()))
            decided = {tuple(n.outputs) for n in net.nodes.values()}
            assert len(decided) == 1 and net.observer.outputs == list(next(iter(decided)))
            if inputs is not None:
                assert decided == {(inputs,)}
            nets[f"n{size}-t{trial}"] = net
    return nets


@pytest.mark.parametrize("inputs", [True, False, None], ids=["true", "false", "random"])
def test_agreement_sizes_mock_match_reference(inputs):
    twin(_run_agreement, 20, (1, 2, 3, 4, 7, 10), inputs)


def test_agreement_first_scheduler_matches_reference():
    twin(_run_agreement, 21, (4, 7), None, kind="first")


def test_agreement_real_bls_matches_reference():
    twin(_run_agreement, 22, (4,), None, mock=False, trials=3)


def _flip(side, seed, size, nonces, mock, kind="random"):
    rng = random.Random(seed)
    out = {}
    for nonce in nonces:
        f = (size - 1) // 3
        net = side.network(
            size - f, f, side.silent(rng, kind), lambda ni: side.coin.CommonCoin(ni, nonce), rng,
            mock_crypto=mock,
        )
        net.input_all(None)
        net.observer.handle_input(None)
        assert not net.observer.messages
        net.step_until(lambda: all(n.outputs for n in net.nodes.values()))
        values = {tuple(n.outputs) for n in net.nodes.values()}
        assert len(values) == 1 and net.observer.outputs == list(next(iter(values)))
        out[nonce.decode()] = net
    return out


@pytest.mark.parametrize("kind", ["random", "first"])
def test_coin_mock_distribution_matches_reference(kind):
    ref, port = twin(_flip, 10, 4, [b"flip-%d" % i for i in range(64)], True, kind)
    trues = sum(net.nodes[0].outputs[0] for net in port.values())
    assert 16 <= trues <= 48, trues


@pytest.mark.parametrize("size", [1, 2, 4, 7, 10, 13])
def test_coin_mock_sizes_match_reference(size):
    twin(_flip, 11, size, [b"size-%d" % size], True)


def test_coin_real_bls_matches_reference():
    twin(_flip, 12, 4, [b"real-%d" % i for i in range(3)], False)


def _coin_bad_share(side):
    """A forged real signature share is attributed and ignored."""
    nis = side.ni.NetworkInfo.generate_map(range(4), random.Random(13), mock=False, ops=side.ops())
    nonce = side.coin.make_nonce(nis[0].invocation_id(), 0, 1, 2)
    coin = side.coin.CommonCoin(nis[0], nonce)
    steps = [coin.handle_input()]
    forged = nis[2].secret_key_share.sign(b"another nonce")
    steps.append(coin.handle_message(1, side.coin.CommonCoinMessage(forged)))
    steps.append(coin.handle_message(2, side.coin.CommonCoinMessage(nis[2].secret_key_share.sign(nonce))))
    steps.append(coin.handle_message(3, "junk"))
    return {
        "nonce": nonce,
        "faults": [[f.compact() for f in st.fault_log] for st in steps],
        "outputs": [st.output for st in steps],
        "messages": [[tm.message for tm in st.messages] for st in steps],
    }


def test_coin_real_bls_bad_share_matches_reference():
    ref, port = twin(_coin_bad_share)
    assert ref["faults"][1] == ["1:INVALID_SIGNATURE_SHARE"]


def _garbage(side, seed):
    rng = random.Random(seed)
    return [side.ag.random_message(rng) for _ in range(40)]


def test_random_agreement_messages_match_reference():
    twin(_garbage, 14)
