"""Twin runs of the sequential engines: reference against port.

A scenario is a function ``scenario(side, ...)`` written once against
:class:`Side`, which names a package's modules by short attribute
(``side.net`` is ``<pkg>.harness.network``, ``side.hb`` is
``<pkg>.protocols.honey_badger``, ...).  :func:`twin` runs it through
the reference (``hbbft_tpu``, on its host backend) and through the port
(``hbbft_tpu_torch``, on ``CudaBackend(device="cpu")``, or a
``BatchingBackend`` over it) from the same seeds, and asserts that the
two runs agree exactly: the node id every ``TestNetwork.step()``
returned, every node's outputs as ``dumps`` bytes, every fault log in
``compact()`` form, and whatever else the scenario returns (compared as
``dumps`` bytes of the port's and the reference's canonical forms).
"""

import importlib

MODULES = {
    "net": "harness.network",
    "batching": "harness.batching",
    "step": "core.step",
    "fault": "core.fault",
    "algorithm": "core.algorithm",
    "ni": "core.network_info",
    "ser": "core.serialize",
    "mock": "crypto.mock",
    "T": "crypto.threshold",
    "poly": "crypto.poly",
    "bool_set": "protocols.bool_set",
    "bc": "protocols.broadcast",
    "sbv": "protocols.sbv_broadcast",
    "coin": "protocols.common_coin",
    "ag": "protocols.agreement",
    "cs": "protocols.common_subset",
    "hb": "protocols.honey_badger",
    "skg": "protocols.sync_key_gen",
    "change": "protocols.change",
    "votes": "protocols.votes",
    "dhb": "protocols.dynamic_honey_badger",
    "qhb": "protocols.queueing_honey_badger",
}


class Side:
    """One package, its modules by short name, its backends and a
    recorder of the steps its networks take."""

    def __init__(self, root: str):
        self.root = root
        self.is_port = root == "hbbft_tpu_torch"

    def __getattr__(self, name):
        if name not in MODULES:
            raise AttributeError(name)
        return importlib.import_module(f"{self.root}.{MODULES[name]}")

    def __repr__(self):
        return f"Side({self.root})"

    def ops(self, batching: bool = False):
        """The backend a scenario runs on: the reference's host backend,
        the port's card route on the CPU; either under the batching
        façade when asked."""
        if self.is_port:
            from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

            inner = CudaBackend(device="cpu")
        else:
            from hbbft_tpu.crypto.backend import CpuBackend

            inner = CpuBackend()
        return self.batching.BatchingBackend(inner=inner) if batching else inner

    def network(self, good, adv, adversary_factory, new_algo, rng, **kw):
        """A ``TestNetwork`` whose ``step()`` results are recorded in
        ``net.trace``."""
        kw.setdefault("ops", self.ops())
        net = self.net.TestNetwork(good, adv, adversary_factory, new_algo, rng, **kw)
        net.trace = []
        inner_step = net.step

        def step():
            nid = inner_step()
            net.trace.append(nid)
            return nid

        net.step = step
        return net

    def silent(self, rng, kind="random"):
        """A factory of ``SilentAdversary`` over one scheduler."""
        S = self.net.MessageScheduler
        return lambda adv: self.net.SilentAdversary(
            S(S.RANDOM if kind == "random" else S.FIRST, rng)
        )

    def canon(self, obj) -> bytes:
        """``dumps`` bytes; a ``DhbBatch`` (not a wire type) as the tuple
        of its fields."""
        if type(obj).__name__ == "DhbBatch":
            obj = ("DhbBatch", obj.epoch, obj.contributions, obj.change, obj.pub_netinfo)
        return self.ser.dumps(obj)

    def outcome(self, net) -> dict:
        """Everything a network run produced, in comparable form."""
        nodes = dict(net.nodes)
        nodes[net.OBSERVER_ID] = net.observer
        return {
            "steps": list(net.trace),
            "outputs": {repr(k): [self.canon(o) for o in n.outputs] for k, n in nodes.items()},
            "faults": {repr(k): [f.compact() for f in n.faults] for k, n in nodes.items()},
        }


REF = Side("hbbft_tpu")
PORT = Side("hbbft_tpu_torch")


def twin(scenario, *args, **kw):
    """Run ``scenario`` through the reference and the port; assert the
    outcomes are identical and return ``(ref_result, port_result)``.

    A scenario returns a network (compared by :meth:`Side.outcome`), a
    dict of named results (networks compared by their outcome, other
    values by ``Side.canon``), or any wire-able value."""
    ref = scenario(REF, *args, **kw)
    port = scenario(PORT, *args, **kw)
    assert _flat(REF, ref) == _flat(PORT, port)
    return ref, port


def _flat(side, result):
    if hasattr(result, "trace") and hasattr(result, "nodes"):
        return side.outcome(result)
    if isinstance(result, dict) and all(isinstance(k, str) for k in result):
        return {k: _flat(side, v) for k, v in result.items()}
    return side.canon(result)
