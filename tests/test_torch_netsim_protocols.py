"""The port's event engine under Bk, Ethereum and Spar (the plain versions
of K12-event-bk, K12-event-eth and K12-event-spar) against
`cpr_tpu.netsim.Engine` on the CPU.

Both engines get the same topology (`convert.compiled_net` of the JAX
package's), seeds and activation delays: a 5-node clique (propagation
1.0), 2 lanes x 160 activations at activation delays 50 and 200, and
one flooding topology.
Integer outputs and the float32 rewards must be equal bit for bit (every
reward term is dyadic, so the float32 sums are exact in any order); the
float64 times within TIME_RTOL, whose decisions the port's smallest
decision margin shows to be far from any rounding. The JAX reference
runs once per case, at module scope.

Also: the engine's sizes for each protocol (`B`, `U`, `W`), each
protocol's progress and on_chain, the Bk vote hash drawn as the JAX
package draws it under 64-bit mode, and the tie order of the quorum and
uncle selections (a stable sort: equal keys in ledger order). The
forced window misses, the other flooding cases and two more
configurations are cases of test_torch_netsim_protocols_golden.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from cpr_tpu import netsim as jnetsim
from cpr_tpu_torch import convert, netsim
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.netsim import engine as E
from test_torch_netsim import (INT_KEYS, TIME_KEYS, TIME_RTOL,  # noqa: F401
                               assert_parity, clique, flooding_net, jax_x64,
                               one_torch_thread)

SEEDS, DELAYS = [3, 11], [50.0, 200.0]
A = 160
# (protocol, k, scheme, topology, activations); Bk k=2 and Spar k=1 under
# `block` are cases of the golden fixture
CASES = {
    "bk2_constant": ("bk", 2, "constant", "clique", A),
    "bk4_constant": ("bk", 4, "constant", "clique", A),
    "bk4_block": ("bk", 4, "block", "clique", A),
    "eth_whitepaper": ("ethereum-whitepaper", 1, "constant", "clique", A),
    "eth_byzantium": ("ethereum-byzantium", 1, "constant", "clique", A),
    "spar1_constant": ("spar", 1, "constant", "clique", A),
    "spar4_constant": ("spar", 4, "constant", "clique", A),
    "spar4_block": ("spar", 4, "block", "clique", A),
    "bk2_flooding": ("bk", 2, "constant", "flooding", 40),
}


def jax_net(topology):
    return clique() if topology == "clique" else flooding_net()


def run_case(name):
    """(the port's outputs as Engine.run gives them, the reference's, the
    port's smallest decision margin)."""
    proto, k, scheme, topo, acts = CASES[name]
    jcn = jnetsim.compile_network(jax_net(topo))
    ref = jnetsim.Engine(jcn, protocol=proto, k=k, scheme=scheme,
                         activations=acts).run(SEEDS, DELAYS)
    tcn = convert.compiled_net(jcn)
    eng = netsim.Engine(tcn, protocol=proto, k=k, scheme=scheme,
                        activations=acts, device="cpu")
    out = E.event_plain(tcn, acts, eng.B, eng.M, eng.F, eng.S,
                        E.lane_keys(SEEDS, "cpu"),
                        torch.tensor(DELAYS, dtype=torch.float64), eng.proto)
    margin = float(out.pop("margin").min())
    return E.finish(out), {k: np.asarray(v) for k, v in ref.items()}, margin


@pytest.fixture(scope="module")
def runs():
    """Each case's run, made the first time a test asks for it (under the
    jax_x64 stand-in of the asking test)."""
    return {}


def case(runs, name):
    if name not in runs:
        runs[name] = run_case(name)
    return runs[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_protocol_matches_reference(runs, name):
    out, ref, margin = case(runs, name)
    proto, k, scheme, topo, acts = CASES[name]
    print(f"{name}: smallest decision margin {margin:.3e} (times up to "
          f"{ref['sim_time'].max():.0f}), steps {ref['steps'].tolist()}")
    assert margin > TIME_RTOL * float(ref["sim_time"].max())
    assert_parity(out, ref, name)
    # a healthy run: no overflow, no window miss, every activation there
    for key in ("drop_q", "drop_p", "drop_b", "win_miss"):
        assert not np.any(out[key]), (name, key, out[key])
    assert not np.any(out["exhausted"])
    assert np.all(out["node_act"].sum(1) == acts)


def test_progress_and_on_chain_per_protocol(runs):
    """Each protocol's finalize returns its own progress and on_chain
    (engine.py:618-636): Bk k·h and (k+1)·h, Spar k·h and k·h, Ethereum
    the head's height (whitepaper) or work (Byzantium) and the chain's
    blocks plus their uncles; the constant schemes pay out progress."""
    for name in ("bk4_constant", "spar4_constant", "eth_whitepaper",
                 "eth_byzantium"):
        out, ref, _ = case(runs, name)
        hh = out["head_height"].astype(np.float64)
        for key in ("progress", "on_chain"):
            np.testing.assert_array_equal(out[key], ref[key])
        if name == "bk4_constant":
            np.testing.assert_array_equal(out["progress"], 4 * hh)
            np.testing.assert_array_equal(out["on_chain"], 5 * hh)
        elif name == "spar4_constant":
            np.testing.assert_array_equal(out["progress"], 4 * hh)
            np.testing.assert_array_equal(out["on_chain"], 4 * hh)
        elif name == "eth_whitepaper":
            np.testing.assert_array_equal(out["progress"], hh)
        else:
            assert np.all(out["progress"] >= hh)
        if name.startswith("eth"):
            assert np.all(out["on_chain"] >= hh)
            assert np.all(out["reward"].sum(1) >= hh)
        else:
            np.testing.assert_array_equal(out["reward"].sum(1),
                                          out["progress"])


@pytest.mark.parametrize("proto,k,acts", [
    ("bk", 4, 10_000), ("bk", 8, 10_000), ("bk", 2, 37),
    ("ethereum-whitepaper", 1, 10_000), ("ethereum-byzantium", 1, 10_000),
    ("spar", 4, 10_000), ("nakamoto", 1, 500)])
def test_engine_sizes_match_reference(proto, k, acts):
    """The ledger (Bk: room for the proposals), the uncle capacity
    (Byzantium's 2, 8 otherwise), the quorum window and the step cap are
    the JAX package's."""
    jnet = clique(10, ad=30.0)
    ref = jnetsim.Engine(jnet, protocol=proto, k=k, activations=acts)
    eng = netsim.Engine(convert.compiled_net(jnetsim.compile_network(jnet)),
                        protocol=proto, k=k, activations=acts, device="cpu")
    for f in ("B", "U", "W", "M", "F", "S"):
        assert getattr(eng, f) == getattr(ref, f), (proto, f)
    for kw in (dict(block_cap=333, uncle_cap=3, window=17),):
        ref = jnetsim.Engine(jnet, protocol=proto, k=k, activations=acts,
                             **kw)
        eng = netsim.Engine(convert.compiled_net(jnetsim.compile_network(
            jnet)), protocol=proto, k=k, activations=acts, device="cpu",
            **kw)
        assert (eng.B, eng.U, eng.W) == (ref.B, ref.U, ref.W)


def test_bk_vote_hash_is_the_reference_draw():
    """Bk's vote hash: slot 2 of a step's 5-way split, a float32 uniform
    that the JAX package draws under 64-bit mode (engine.py:299); the
    plain versions draw it in the same threefry pass as the miner."""
    from cpr_tpu_torch.netsim.compile import CompiledNet
    cn = convert.compiled_net(jnetsim.compile_network(clique()))
    assert isinstance(cn, CompiledNet)
    seeds = [0, 5, 2**33 + 1, 123456789]
    keys = E.lane_keys(seeds, "cpu")
    led = E.EventLedger(cn, 10, 12, 16, 2, keys, torch.full((4,), 50.0),
                        E.Proto("bk", 2, "constant", 12, 8))
    ks = rnd.split(keys, 5)
    m, _, _, powh = led.draws(ks[:, 1], ks[:, 3], ks[:, 4],
                              E.log_compute(cn, "cpu"), ks[:, 2])
    with jax.enable_x64(True):
        want, want_m = [], []
        for s in seeds:
            sub = jax.random.split(jax.random.PRNGKey(s), 5)
            want.append(np.asarray(jax.random.uniform(
                sub[2], dtype=jax.numpy.float32)))
            want_m.append(int(jax.random.categorical(
                sub[1], jax.numpy.log(jax.numpy.asarray(
                    cn.compute, jax.numpy.float32)))))
    assert powh.dtype == torch.float32
    np.testing.assert_array_equal(powh.numpy(), np.stack(want))
    np.testing.assert_array_equal(m.numpy(), want_m)
    # without Bk the pass draws no hash
    led = E.EventLedger(cn, 10, 12, 16, 2, keys, torch.full((4,), 50.0))
    assert len(led.draws(ks[:, 1], ks[:, 3], ks[:, 4],
                         E.log_compute(cn, "cpu"))) == 3


def hand_ledger(proto, rows, nb, N=3):
    """An EventLedger of one lane whose blocks 1.. are `rows` of (parent,
    height, miner, is_vote, powh, visible-at-node-0) and nb = `nb`."""
    cn = convert.compiled_net(jnetsim.compile_network(clique(N)))
    led = E.EventLedger(cn, 50, 24, 16, 2, E.lane_keys([0], "cpu"),
                        torch.full((1,), 50.0), proto)
    st = led.st
    for i, (par, h, mn, vote, ph, vis0) in enumerate(rows, start=1):
        st["parent0"][0, i], st["height"][0, i] = par, h
        st["miner"][0, i] = mn
        st["vis"][0, 0, i] = vis0
        if "is_vote" in st:
            st["is_vote"][0, i] = vote
        if "powh" in st:
            st["powh"][0, i] = ph
    st["nb"][0] = nb
    return led


def test_bk_quorum_takes_smallest_own_hashes_then_others_in_order():
    """Node 0 proposes on block 1: its own votes sorted by hash, equal
    hashes in ledger order (`jnp.argsort` is stable), then others' votes
    of larger hash than its best, in ledger order (engine.py:439-456)."""
    rows = [(0, 1, 1, False, 2.0, True)]            # block 1, by node 1
    votes = [(0, 0.5), (1, 0.25), (0, 0.25), (2, 0.75), (0, 0.5),
             (1, 0.125), (2, 0.9), (0, 0.25)]       # (miner, hash)
    rows += [(1, 1, mn, True, ph, True) for mn, ph in votes]
    # own votes by (hash, slot): 4 (0.25), 9 (0.25), 2 (0.5), 6 (0.5);
    # then others' votes of hash above the best own 0.25, in ledger order:
    # 5 (0.75), 8 (0.9) (3's 0.25 and 7's 0.125 are not above it)
    for k, want in ((3, [4, 9, 2]), (4, [4, 9, 2, 6]),
                    (6, [4, 9, 2, 6, 5, 8])):
        led = hand_ledger(E.Proto("bk", k, "constant", 16, 8), rows, 10)
        st = led.st
        st["pref"][0, 0] = 1
        st["mybest"][0, 0, 1] = 0.25
        st["conf"][0, 0, 1] = 8
        st["conf_own"][0, 0, 1] = 4
        want_mask = torch.tensor([[True, False, False]])
        jstar, pjs, mb, feasible, q_row, miss = led.bk_proposal(st, want_mask)
        assert int(jstar) == 0 and int(pjs) == 1 and float(mb) == 0.25
        assert bool(feasible) and not bool(miss)
        assert q_row[0].tolist() == want, (k, q_row)


def test_spar_quorum_takes_own_first_then_others_in_order():
    """A Spar block's k - 1 quorum: the miner's own votes in ledger order,
    then others' in ledger order (engine.py:387-407); where the window
    shows too few, the JAX package's rank scatter reads its zero, the
    window's first slot."""
    rows = [(0, 1, 1, False, 2.0, True)]
    votes = [1, 0, 2, 0, 1, 0]                      # miners of votes 2..7
    rows += [(1, 1, mn, True, 2.0, True) for mn in votes]
    for k, want in ((3, [3, 5]), (5, [3, 5, 7, 2]), (8, [3, 5, 7, 2, 4, 6,
                                                       2])):
        led = hand_ledger(E.Proto("spar", k, "constant", 16, 8), rows, 8)
        st = led.st
        st["pref"][0, 0] = 1
        st["conf"][0, 0, 1] = 6
        st["conf_own"][0, 0, 1] = 3
        m = torch.tensor([0])
        can_block, q_row, miss = led.spar_quorum(st, m, torch.tensor([1]))
        assert bool(can_block) == (6 >= k - 1)
        assert not bool(miss)
        assert q_row[0].tolist() == want, (k, q_row)


def test_eth_uncles_own_first_then_lower_key_then_slot():
    """Ethereum's uncles at a mint by node 0 on tip 4 (chain 0-1-2-3-4):
    blocks visible to the miner whose parent is a window ancestor and
    that are off the chain, own first, then the lower height, equal keys
    in ledger order (engine.py:349-360); the first U taken, and a
    whitepaper miss when more are there."""
    rows = [(0, 1, 1, False, 2.0, True), (1, 2, 1, False, 2.0, True),
            (2, 3, 2, False, 2.0, True), (3, 4, 1, False, 2.0, True),
            (1, 2, 2, False, 2.0, True),      # 5: uncle at height 2
            (2, 3, 0, False, 2.0, True),      # 6: own, height 3
            (0, 1, 1, False, 2.0, True),      # 7: height 1
            (1, 2, 1, False, 2.0, True),      # 8: height 2, after 5
            (3, 4, 2, False, 2.0, False)]     # 9: invisible to node 0
    for proto, U, want, miss in (
            ("ethereum-byzantium", 2, [6, 7], False),
            ("ethereum-whitepaper", 8, [6, 7, 5, 8, -1, -1, -1, -1], False),
            ("ethereum-whitepaper", 3, [6, 7, 5], True)):
        led = hand_ledger(E.Proto(proto, 1, "constant", 16, U), rows, 10)
        st = led.st
        st["work"][0, 1:10] = st["height"][0, 1:10]
        row, n_unc, m = led.eth_uncles(st, torch.tensor([0]),
                                       torch.tensor([4]))
        assert row[0].tolist() == want, (proto, U, row)
        assert int(n_unc) == min(4, U) and bool(m) == miss


def test_protocol_kernel_wrapper_refuses_cpu_tensors():
    """The protocols' kernel wrapper takes CUDA tensors only and names its
    kernel; it launches nothing here."""
    from cpr_tpu_torch import kernels
    cn = convert.compiled_net(jnetsim.compile_network(clique()))
    keys = E.lane_keys([0, 1], "cpu")
    dl = torch.full((2,), 50.0, dtype=torch.float64)
    before = dict(kernels.launches)
    for proto, kern in (("bk", "K12-event-bk"),
                        ("ethereum-whitepaper", "K12-event-eth"),
                        ("ethereum-byzantium", "K12-event-eth"),
                        ("spar", "K12-event-spar")):
        eng = netsim.Engine(cn, protocol=proto, k=2, activations=10,
                            device="cpu")
        with pytest.raises(ValueError, match=f"{kern} takes CUDA"):
            kernels.netsim_event_protocol(cn, eng.proto, 10, eng.B, eng.M,
                                          eng.F, eng.S, keys, dl)
    with pytest.raises(ValueError, match="no event kernel"):
        kernels.netsim_event_protocol(cn, E.NAKAMOTO, 10, 12, 256, 8, 100,
                                      keys, dl)
    assert kernels.launches == before
    assert {"K12-event-bk", "K12-event-eth", "K12-event-spar"} <= \
        set(kernels.launches)
    # the shared memory a lane asks for: the queue and pending buffers,
    # then four scratch arrays and Ethereum's chain set
    assert kernels.proto_smem(576, 8, 8) == (4 * 576 + 7 + 48) * 4
