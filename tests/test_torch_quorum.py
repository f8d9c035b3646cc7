"""Port parity of the vote-quorum layer (`cpr_tpu_torch.envs.quorum`, the
plain twin of K9) against cpr_tpu.envs.quorum on the CPU.

Carries of seeded JAX Tailstorm and Stree runs, at several steps, in
ring mode (windows that wrap) and in full mode, cross into the port with
`convert`; the port's `check_inputs` asks each lane for a quorum (on its
private tip, its public tip or its most-confirmed block, for either
party, with either vote filter), and every function of the layer runs on
them in both packages — the candidate frame (slots, validity, closure
rows), the heuristic, altruistic and optimal selections (inside and
beyond the optimal window) with their parent rows, the release sets and
new head, the stale plane after an Adopt. Every output must be equal.
`check_plain` is the plain twin of K9's check kernel, which chip_smoke.py
holds against it on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import quorum as JQ
from cpr_tpu.envs.stree import StreeSSZ as JStree
from cpr_tpu.envs.tailstorm import TailstormSSZ as JTs
from cpr_tpu_torch import convert
from cpr_tpu_torch.envs import quorum as Q
from cpr_tpu_torch.envs.stree import StreeSSZ as TStree
from cpr_tpu_torch.envs.tailstorm import TailstormSSZ as TTs
from test_torch_bk import jax_state_numpy, keys, params

LANES, AT_STEPS, MAX_STEPS = 32, (9, 30, 57), 40
# name: (JAX env, port env, kwargs, policy)
CASES = {
    "ts-ring128-k8": (JTs, TTs, dict(k=8, window=128), "avoid-loss"),
    "ts-ring32-k3-hybrid": (JTs, TTs, dict(k=3, window=32,
                                           incentive_scheme="hybrid"),
                            "avoid-loss-a"),
    "ts-full-k2-punish": (JTs, TTs, dict(k=2, incentive_scheme="punish",
                                         max_steps_hint=40), "long-delay"),
    "stree-ring32-k4-discount": (JStree, TStree,
                                 dict(k=4, window=32,
                                      incentive_scheme="discount"),
                                 "override-catchup"),
    "stree-full-k3-hybrid": (JStree, TStree,
                             dict(k=3, incentive_scheme="hybrid",
                                  max_steps_hint=40), "avoid-loss"),
}
INPUTS = ("cand", "own", "seen", "score", "stale", "pub", "priv")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def jax_carries(jenv, jp, jkeys, policy, at_steps):
    """The reference's auto-reset stream states at the given steps."""
    pol = jenv.policies[policy]
    body = jax.jit(jax.vmap(
        lambda c: jenv._autoreset_body(jp, pol)(c, None)[0]))
    carry = jax.jit(jax.vmap(lambda k: jenv._stream_init(k, jp)))(jkeys)
    out = []
    for t in range(max(at_steps) + 1):
        if t in at_steps:
            out.append(carry[0])
        carry = body(carry)
    return out


def jax_check(jenv, jdag, inputs: dict, cfg: dict) -> dict:
    """`check_plain`'s outputs computed by cpr_tpu.envs.quorum (vmapped
    over lanes) on the same DAGs and inputs (numpy), with the env's own
    preference and chain pointer."""
    q, C, W, env = cfg["q"], cfg["C"], cfg["window"], cfg["env"]
    combos = JQ.optimal_combos(q, W)

    def cmp(dag, x, y, mask):
        if env == 0:
            return jenv.cmp_summaries(dag, x, y, mask, jnp.int32(1))
        return jenv.cmp_blocks(dag, x, y, mask)

    def prev(dag, i):
        return dag.aux2[i] if env == 0 else dag.parent0[i]

    def lane(dag, cand, own, seen, score, stale, pub, priv):
        cidx, cvalid, abits, oh = JQ.candidate_frame(dag, cand, C, 1)
        fh, lh = JQ.quorum_heuristic(dag, cidx, cvalid, abits, oh, own, q)
        n, _, la, nc = JQ.quorum_altruistic(dag, cidx, cvalid, abits, oh,
                                            own, seen, dag.aux, q)
        fo, lo = JQ.quorum_optimal_or_heuristic(
            dag, cidx, cvalid, abits, oh, own, dag.aux, q, W, combos,
            k=cfg["k"], discount=bool(cfg["discount"]),
            punish=bool(cfg["punish"]), depth_plus=cfg["depth_plus"],
            leaf_score=score, miner_share=cfg["miner_share"])
        leaves = (lh, la, lo)
        last_all = JQ.last_of_kind_all(dag, 0)
        cands = dag.exists() & ~dag.vis_d & ~stale
        ovr, mat, rf, head = JQ.prefix_release_sets(
            dag, pub, priv, cands, cfg["R"], last_all, cmp,
            extra_all=dag.auxg if env == 0 else None)
        st = JQ.stale_after_adopt(dag, pub, stale, jnp.bool_(True),
                                  cfg["R"], Q.STALE_WALK, last_all, prev)
        return dict(
            cidx=cidx, cvalid=cvalid, abits=abits,
            found=jnp.stack([fh, (n == q) & (nc >= q), fo]),
            leaves=jnp.stack(leaves),
            row=jnp.stack([JQ.leaves_to_row(dag, cidx, lv, cvalid,
                                            cfg["width"], score)
                           for lv in leaves]),
            ovr=ovr, mat=mat, rfound=rf, head=head, stale=st)

    out = jax.jit(jax.vmap(lane))(jdag, *(jnp.asarray(np.asarray(inputs[f]))
                                          for f in INPUTS))
    out = {k: np.asarray(v) for k, v in out.items()}
    for k in ("found", "leaves", "row"):
        out[k] = np.swapaxes(out[k], 0, 1)
    return out


def assert_check(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jcls, tcls, kw, policy = CASES[request.param]
    jenv, tenv = jcls(**kw), tcls(**kw)
    jp, _ = params(max_steps=MAX_STEPS)
    jk, _ = keys(17, LANES)
    return (request.param, jenv, tenv,
            jax_carries(jenv, jp, jk, policy, AT_STEPS))


def test_every_function_matches_reference(case):
    name, jenv, tenv, carries = case
    cfg = Q.check_cfg(tenv)
    stats = np.zeros(4, int)
    for t, jstate in zip(AT_STEPS, carries):
        state = convert.dag_state_from_numpy(tenv, jax_state_numpy(jstate),
                                             device="cpu")
        inputs = Q.check_inputs(tenv, state)
        got = Q.check_plain(state.dag, inputs, cfg)
        assert_check({k: v.numpy() for k, v in got.items()},
                     jax_check(jenv, jstate.dag, inputs, cfg),
                     f"{name} step {t}")
        cv = got["cvalid"]
        beyond = (cv & (torch.arange(cfg["C"]) >= cfg["window"])).any(1)
        stats += [int(got["found"].sum()), int(beyond.sum()),
                  int((~beyond & cv.any(1)).sum()), int(got["rfound"].sum())]
    # the checks met quorums, optimal frames inside the window and (at
    # k = 8, where blocks gather more votes than the window holds) beyond
    # it, and flipping release prefixes
    met = stats > 0
    if tenv.k < 8:
        met[1] = True
    assert met.all(), (name, stats)


def test_last_of_kind_and_optimal_tables():
    """last_of_kind_all on fresh states, and the optimal selection's
    window and subset table (the port's own copies)."""
    env = TTs(k=2, window=32)
    jenv = JTs(k=2, window=32)
    jp, tp = params(max_steps=8)
    jk, tk = keys(2, 4)
    js = jax.vmap(lambda k: jenv.reset(k, jp)[0])(jk)
    ts = env.reset(tk, tp)[0]
    for d in (np.asarray(jax.vmap(lambda d: JQ.last_of_kind_all(d, 0))(
            js.dag)),):
        np.testing.assert_array_equal(
            Q.last_of_kind_all(ts.dag, 0).numpy(), d)
    assert Q.optimal_window(8, 48) == JQ.optimal_window(8, 48) == 10
    assert Q.optimal_window(7, 48) == JQ.optimal_window(7, 48) == 9
    for q, W in ((8, 10), (7, 9), (2, 14)):
        np.testing.assert_array_equal(Q.optimal_combos(q, W),
                                      JQ.optimal_combos(q, W))
