"""The port's frontier-batched compiler against its serial `Compiler`
and against `cpr_tpu.mdp.frontier`: the same columns byte for byte, at
one worker and at two (spawned worker processes that import the port,
never jax), the tracer's exponent columns included, and the
`mdp_compile` event with the reference's fields."""

import io
import json

import numpy as np
import pytest

from cpr_tpu import telemetry as J_telemetry
from cpr_tpu.mdp.frontier import FrontierCompiler as JFrontier
from cpr_tpu.mdp.models import Aft20BitcoinSM as JAft20
from cpr_tpu.mdp.models import Fc16BitcoinSM as JFc16
from cpr_tpu_torch import telemetry
from cpr_tpu_torch.mdp import Compiler
from cpr_tpu_torch.mdp.frontier import FrontierCompiler
from cpr_tpu_torch.mdp.models import Aft20BitcoinSM, Fc16BitcoinSM

MODELS = {"fc16": (Fc16BitcoinSM, JFc16), "aft20": (Aft20BitcoinSM, JAft20)}
MFL = 8


def columns(mdp):
    return [np.ascontiguousarray(c).tobytes() for c in mdp.arrays()]


def port_model(proto, **kw):
    return MODELS[proto][0](alpha=0.3, gamma=0.5, maximum_fork_length=MFL,
                            **kw)


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("proto", sorted(MODELS))
def test_frontier_bytes_equal_serial_and_reference(proto, workers):
    fc = FrontierCompiler(port_model(proto), n_workers=workers)
    got = fc.mdp()
    serial = Compiler(port_model(proto)).mdp()
    ref = JFrontier(MODELS[proto][1](alpha=0.3, gamma=0.5,
                                     maximum_fork_length=MFL)).mdp()
    for want in (serial, ref):
        assert (got.n_states, got.n_actions) == (want.n_states,
                                                 want.n_actions)
        assert columns(got) == columns(want)
        assert got.start == want.start
    assert len(fc.states) == got.n_states


def test_two_workers_shard_the_frontier():
    fc = FrontierCompiler(port_model("fc16"), n_workers=2)
    fc.min_shard = 1  # shard every round, even the first
    got = fc.mdp()
    assert columns(got) == columns(Compiler(port_model("fc16")).mdp())


def test_param_mdp_matches_reference_exponent_columns():
    from cpr_tpu.mdp.grid import compile_protocol as j_compile
    from cpr_tpu_torch.mdp.grid import compile_protocol

    for proto in sorted(MODELS):
        for workers in (1, 2):
            pm = compile_protocol(proto, cutoff=MFL, n_workers=workers)
            jp = j_compile(proto, cutoff=MFL)
            assert columns(pm.mdp) == columns(jp.mdp)
            for f in ("coef", "expo", "start_ids", "start_coef",
                      "start_expo"):
                np.testing.assert_array_equal(getattr(pm, f),
                                              getattr(jp, f))
            assert pm.fingerprint() == jp.fingerprint()


def test_mdp_compile_event_carries_the_reference_fields():
    sink, jsink = io.StringIO(), io.StringIO()
    telemetry.configure(stream=sink)
    J_telemetry.configure(stream=jsink)
    try:
        FrontierCompiler(port_model("fc16"), protocol="fc16",
                         cutoff=MFL).mdp()
        JFrontier(JFc16(alpha=0.3, gamma=0.5, maximum_fork_length=MFL),
                  protocol="fc16", cutoff=MFL).mdp()
    finally:
        telemetry.configure(None)
        J_telemetry.configure(None)

    def compile_event(text):
        evs = [json.loads(line) for line in text.splitlines()]
        return [e for e in evs if e.get("name") == "mdp_compile"][0]

    got, want = compile_event(sink.getvalue()), compile_event(
        jsink.getvalue())
    payload = set(want) - {"ts", "v", "schema", "run_id", "seq", "pid",
                           "host", "t", "wall"}
    assert payload <= set(got)
    for k in ("protocol", "cutoff", "rounds", "states", "transitions",
              "n_workers", "resumed"):
        assert got[k] == want[k], k


def test_checkpoints_are_not_ported():
    with pytest.raises(NotImplementedError, match="item 6"):
        FrontierCompiler(port_model("fc16"), checkpoint_path="c.npz")
