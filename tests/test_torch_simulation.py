"""The virtual-time simulator in the port against the reference's.

``hbbft_tpu/harness/simulation.py`` and its port
``hbbft_tpu_torch/harness/simulation.py`` read their clock through a
module-level ``_time``; each run here replaces both with a fresh
deterministic counter (``chip_smoke.StepClock``), so that the virtual times are
exact and the two packages must agree with tolerance 0: the epoch rows
with their times, the rendered table, the message counts and sizes,
every node's outputs (``dumps`` bytes, with their times) and the
scheduler rng's final state.  Covered: ``tests/test_simulation.py``'s
three mock runs, ``bench_sim_real_pair``'s real-BLS shape batched and
unbatched, ``SimNetwork``'s obligation rule, its obligation queue and
its rng tie-break, and the ``examples/torch_simulation.py`` CLI against
``examples/simulation.py``.  The port runs on
``CudaBackend(device="cpu")``.
"""

import contextlib
import importlib.util
import io
import pathlib
import random
import sys

import pytest
import torch

import hbbft_tpu.harness.simulation as RS
import hbbft_tpu_torch.harness.simulation as PS
from hbbft_tpu.harness.batching import BatchingBackend as RBatching
from hbbft_tpu_torch.harness.batching import BatchingBackend as PBatching
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend
from torch_twin import PORT, REF

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDES = {"ref": (RS, REF), "port": (PS, PORT)}

sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


@pytest.fixture
def clock(monkeypatch):
    """``clock(step)`` installs one fresh counter into both packages'
    simulators; call it again before each run."""

    def install(step=cs.SIM_CLOCK_STEP):
        c = cs.StepClock(step)
        monkeypatch.setattr(RS, "_time", c)
        monkeypatch.setattr(PS, "_time", c)
        return c

    return install


def _ops(side, batched=False):
    if side == "ref":
        return RBatching() if batched else None
    inner = CudaBackend(device="cpu")
    return PBatching(inner=inner) if batched else inner


def _run(side, clock, seed, **kw):
    """One ``simulate_queueing_honey_badger`` run, everything it leaves
    behind in comparable form."""
    mod, canon = SIDES[side][0], SIDES[side][1].canon
    clock()
    rng = random.Random(seed)
    stats, wall, sim_time = mod.simulate_queueing_honey_badger(rng=rng, **kw)
    net = stats.network
    return {
        "rows": stats.rows_as_dicts(),
        "table": [stats.header()] + [stats.format_row(r) for r in stats.rows],
        "dict_rows": [stats.format_row(r.as_dict()) for r in stats.rows],
        "walls": (wall, sim_time),
        "messages": (net.message_count(), net.message_size()),
        "outputs": {nid: [(t, canon(b)) for t, b in n.outputs] for nid, n in net.nodes.items()},
        "clocks": {nid: (n.time, n.sent_time) for nid, n in net.nodes.items()},
        "rng": rng.getstate(),
    }


MOCK_RUNS = {
    "n5": dict(num_nodes=5, num_txs=40, batch_size=20, seed=2),
    "dead": dict(num_nodes=4, num_dead=1, num_txs=20, batch_size=10, seed=3),
    "lag1000": dict(num_nodes=4, num_txs=4, batch_size=4, lag_ms=1000.0, seed=4),
}


@pytest.mark.parametrize("case", sorted(MOCK_RUNS))
def test_mock_runs_match_reference(clock, case):
    kw = dict(MOCK_RUNS[case])
    seed = kw.pop("seed")
    ref = _run("ref", clock, seed, **kw)
    port = _run("port", clock, seed, ops=_ops("port"), **kw)
    assert port == ref
    assert ref["rows"] and ref["table"][1:] == ref["dict_rows"]
    # every transaction committed; virtual time monotone across epochs
    assert sum(r["txs"] for r in port["rows"]) == kw["num_txs"]
    times = [r["max_time"] for r in port["rows"]]
    assert times == sorted(times)
    if case == "lag1000":
        assert port["walls"][1] >= 2.0


def test_real_bls_batched_and_unbatched_match_reference(clock):
    """``bench_sim_real_pair``'s shape: the reference unbatched, the port
    batched (every share check through ``BatchingBackend.prefetch``)
    and unbatched — byte-equal."""
    kw = dict(num_nodes=4, num_txs=24, batch_size=12, mock_crypto=False)
    ref = _run("ref", clock, 0, **kw)
    be = _ops("port", batched=True)
    batched = _run("port", clock, 0, ops=be, **kw)
    unbatched = _run("port", clock, 0, ops=_ops("port"), **kw)
    assert batched == ref
    assert unbatched == ref
    assert be.stats.flushes > 0 and be.stats.prefetched > 0 and be.stats.cache_hits > 0
    assert be.stats.fallback_groups == 0


class _Flood:
    """A stub protocol: an input is multicast; a message ``k < depth``
    is relayed to everyone as ``k + 1``."""

    def __init__(self, step_mod, netinfo, depth=2):
        self.S, self.ni, self.depth = step_mod, netinfo, depth

    def our_id(self):
        return self.ni.our_id

    def handle_input(self, value):
        return self.S.Step().send_all(value)

    def handle_message(self, sender_id, message):
        step = self.S.Step()
        return step.send_all(message + 1) if message < self.depth else step


def _network(side, mock=True, batched=False, num_dead=0, seed=7):
    mod, twin_side = SIDES[side]
    return mod.SimNetwork(
        4, num_dead, lambda ni: _Flood(twin_side.step, ni), mod.HwQuality(), random.Random(seed),
        mock_crypto=mock, ops=_ops(side, batched),
    )


@pytest.mark.parametrize("mock,batched", [(True, False), (True, True), (False, False), (False, True)])
def test_obligations_are_collected_only_for_real_crypto_under_a_batching_backend(mock, batched):
    got = {side: _network(side, mock, batched)._collect_obs for side in SIDES}
    assert got["port"] == got["ref"] == (batched and not mock)


def test_queued_obligations_match_reference(clock):
    """Mid-run, the real-BLS QHB network's queue of share checks
    extracted at enqueue: the same count and kinds as the reference's,
    drained by ``queued_obligations``."""
    counts = {}
    for side in SIDES:
        mod, twin_side = SIDES[side]
        clock()
        rng = random.Random(0)
        qhb, dhb = twin_side.qhb, twin_side.dhb

        def new_algo(ni):
            node_rng = random.Random(f"sim-{ni.our_id}")
            d = dhb.DynamicHoneyBadger(ni, rng=node_rng)
            return qhb.QueueingHoneyBadger.builder(d).batch_size(4).rng(node_rng).build_with_transactions(
                [b"q-%d" % i for i in range(4)])

        net = mod.SimNetwork(4, 0, new_algo, mod.HwQuality(), rng, mock_crypto=False,
                             ops=_ops(side, batched=True))
        kinds = []
        for i in range(400):
            if net.step() is None:
                break
            if i % 4 == 3:
                queued = sorted(type(o).__name__ for o in net.queued_obligations())
                if queued:
                    kinds.append((i, queued))
        assert net.queued_obligations() == []
        assert not any(n.pending_obs for n in net.nodes.values())
        counts[side] = (kinds, [n.message_count for n in net.nodes.values()], rng.getstate())
    assert counts["port"] == counts["ref"]
    assert counts["port"][0]


def test_ties_are_broken_by_the_scheduler_rng(clock):
    """With a clock that never advances every multicast arrives at the
    same virtual time: each step draws from the rng among the tied
    nodes, the same nodes in the same order as the reference's.  A lone
    ready node draws nothing."""
    runs = {}
    for side in SIDES:
        clock(step=0.0)
        net = _network(side, seed=11)
        net.input(0, 0)
        before = net.rng.getstate()
        order = []
        while True:
            nid = net.step()
            if nid is None:
                break
            order.append(nid)
        assert net.rng.getstate() != before
        runs[side] = (order, net.rng.getstate(), net.message_count(), net.message_size())
    assert runs["port"] == runs["ref"]
    assert len(set(runs["port"][0][:3])) > 1
    # one dead node of four and one message in flight: no tie, no draw
    clock(step=0.0)
    net = _network("port", num_dead=3, seed=11)
    net.nodes[1].dead = False
    net.input(0, 5)  # 5 > depth: nobody relays
    before = net.rng.getstate()
    assert net.step() == 1 and net.step() is None
    assert net.rng.getstate() == before


def _cli(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return out.getvalue(), result


def test_cli_default_mode_prints_the_reference_table(clock, monkeypatch):
    argv = ["-n", "4", "-t", "40", "-b", "20", "--seed", "5"]
    ref_cli = _cli("simulation.py", "ref_simulation_cli")
    port_cli = _cli("torch_simulation.py", "torch_simulation_cli")
    clock()
    monkeypatch.setattr(sys, "argv", ["simulation.py"] + argv)
    ref_out, _ = _captured(ref_cli.main)
    clock()
    port_out, summary = _captured(lambda: port_cli.main(argv + ["--device", "cpu"]))
    # under the shared clock the whole output is the same, walls included
    assert port_out == ref_out
    lines = port_out.splitlines()
    assert lines[0] == PS.EpochStats.header(None)
    assert summary["committed"] == 40 and summary["epochs"] == len(lines) - 3
    assert lines[-1].startswith(f"{summary['epochs']} epochs | wall ")


def test_cli_vectorized_virtual_mode_matches_reference(monkeypatch):
    argv = ["-n", "4", "-t", "40", "-b", "20", "--vectorized", "--virtual"]
    ref_cli = _cli("simulation.py", "ref_simulation_cli")
    port_cli = _cli("torch_simulation.py", "torch_simulation_cli")
    monkeypatch.setattr(sys, "argv", ["simulation.py"] + argv)
    ref_out, _ = _captured(ref_cli.main)
    port_out, summary = _captured(lambda: port_cli.main(argv + ["--device", "cpu"]))

    def table(out):
        # Epoch, Txs and Total; Time and SimTime hold host walls
        rows = out.splitlines()
        return rows[0], [(r.split()[0], r.split()[-2], r.split()[-1]) for r in rows[1:-2]]

    assert table(port_out) == table(ref_out)
    assert table(port_out)[0].split() == ["Epoch", "Time", "SimTime", "Txs", "Total"]
    assert summary["committed"] == 40 and summary["epochs"] == len(table(port_out)[1])


def test_cli_refuses_what_the_reference_refuses():
    port_cli = _cli("torch_simulation.py", "torch_simulation_cli")
    for argv in (["-n", "4", "-f", "2"], ["--dynamic"]):
        with pytest.raises(SystemExit):
            with contextlib.redirect_stderr(io.StringIO()):
                port_cli.main(argv + ["--device", "cpu"])


def test_chip_smoke_simulator_runs_on_the_cards_route(monkeypatch):
    """``chip_smoke.py``'s phase 5(e) driver at a small size on the CPU:
    the forced backend sends every flush through ``win_g1``'s route (its
    plain version, on CPU tensors), and the batched run is byte-equal to
    the unbatched one under the step clock."""
    from hbbft_tpu_torch.ops import cuda_ec

    plain = []
    windowed = cuda_ec.windowed_plain
    monkeypatch.setattr(cuda_ec, "windowed_plain", lambda pts, d: plain.append(pts.shape[0]) or windowed(pts, d))
    size = dict(nodes=4, txs=4, batch_size=4, seed=0)
    be = PBatching(inner=cs.forced(CudaBackend(device="cpu")))
    batched = cs.sim_real_run(be, **size)
    unbatched = cs.sim_real_run(CudaBackend(device="cpu"), **size)
    for key in ("rows", "table", "messages", "outputs", "sim_s", "committed"):
        assert batched[key] == unbatched[key], key
    assert batched["committed"] == 4
    assert len(plain) >= be.stats.flushes > 0 and be.stats.fallback_groups == 0
    assert PS._time is not None and not isinstance(PS._time, cs.StepClock)  # the clock is put back
