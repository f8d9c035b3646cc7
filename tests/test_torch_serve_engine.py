"""Port parity of the serve engine (`cpr_tpu_torch.serve.engine`, K14's
plain twin `_burst_plain` and the interactive tick) against cpr_tpu's
`serve/engine.py` on the CPU.

Both engines start from the same seeds and take the same numpy-seeded
schedule of `splice` / `tick` / `burst_run` / `drain_experience`, with
mid-flight admissions and lane reuse, over a table that holds the four
scripted policies, a loaded greedy net, the swappable net `ppo` and
`ppo#sample` (the nets JAX's, carried across by `convert`):

  * first-done registers, actions, done flags and integer state equal;
    observations within 1e-6 (they pass through atan); sampled actions
    equal, the smallest Gumbel margin printed;
  * a spliced lane's burst replays `rollout(PRNGKey(S))`;
  * hot swap: the scripted lanes of a swapped engine stay bit-identical
    to an unswapped one, an identical fingerprint is a no-op, another
    tree is refused with IntegrityError, an unknown name ValueError;
  * the generic plain burst over a DAG env (Tailstorm, 40-slot ring)
    against the reference, and the card's refusals (a DAG env, mesh=)
    named by their ROADMAP items.

Shapes are the reference tests': max_steps 16, 4 lanes, burst 8,
ActorCritic hidden (8,).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.params import make_params as jmake
from cpr_tpu.serve.engine import ResidentEngine as JEngine
from cpr_tpu.train.ppo import ActorCritic as JNet
from cpr_tpu_torch import convert, kernels
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.integrity import IntegrityError
from cpr_tpu_torch.learn import buffer
from cpr_tpu_torch.params import make_params as tmake
from cpr_tpu_torch.serve.engine import BURST_FIELDS, ResidentEngine
from cpr_tpu_torch.train.ppo import ActorCritic, NetPolicy

MAX_STEPS = 16
N_LANES = 4
BURST = 8
HIDDEN = (8,)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def envs():
    return (jregistry.get_sized("nakamoto", MAX_STEPS),
            tregistry.get_sized("nakamoto", MAX_STEPS))


def params_pair(alpha=0.25):
    return (jmake(alpha=alpha, gamma=0.5, max_steps=MAX_STEPS),
            tmake(alpha=alpha, gamma=0.5, max_steps=MAX_STEPS))


def nets(seed):
    """A JAX ActorCritic's params and the port's net holding them."""
    jnet = JNet(4, HIDDEN)
    p = jax.device_get(jnet.init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 4))))
    tnet = ActorCritic(4, 4, HIDDEN, device="cpu")
    with torch.no_grad():
        tnet.flat.copy_(convert.actor_critic_from_flax(
            jax.tree.map(np.asarray, p), "cpu"))
    return jnet, p, tnet


def engine_pair(envs, *, experience=BURST, swap=True, alpha=0.25):
    jenv, tenv = envs
    jp, tp = params_pair(alpha)
    jnet, p, tnet = nets(42)
    jnet2, p2, tnet2 = nets(7)
    jkw = dict(n_lanes=N_LANES, burst=BURST,
               extra_policies={"loaded": lambda o: jnp.argmax(
                   jnet2.apply(p2, o)[0])})
    tkw = dict(n_lanes=N_LANES, burst=BURST,
               extra_policies={"loaded": NetPolicy(tnet2)}, device="cpu")
    if swap:
        jkw.update(swap_policies={"ppo": (lambda w, o: jnet.apply(w, o)[0],
                                          p, "fp0")},
                   sample_policies=("ppo",), experience=experience)
        tkw.update(swap_policies={"ppo": (tnet, tnet.flat.detach().clone(),
                                          "fp0")},
                   sample_policies=("ppo",), experience=experience)
    je = JEngine(jenv, jp, **jkw)
    te = ResidentEngine(tenv, tp, **tkw)
    je.start()
    te.start()
    return je, te


def assert_obs(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6, err_msg=what)


def assert_regs(got, want, what):
    for k in BURST_FIELDS:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")


def assert_batch(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, \
                (what, k, got[k].dtype, v.dtype, got[k].shape, v.shape)
            if k in ("obs", "last_obs"):
                assert_obs(got[k], v, f"{what}: {k}")
            else:
                np.testing.assert_array_equal(got[k], v,
                                              err_msg=f"{what}: {k}")
        else:
            assert got[k] == v, (what, k)


def sample_margins(te, t0, batch):
    """Smallest gap between the two largest perturbed logits of every
    `ppo#sample` step of a drained burst (t0: the step counters before
    it): where it exceeds ~1e-6 the two packages' draws agree."""
    sid = te.policy_ids["ppo#sample"]
    net, flat = te._slots[te._slot_of["ppo"]]
    out = []
    for k, lane in enumerate(batch["lanes"]):
        steps = np.nonzero(batch["policy"][k] == sid)[0]
        if not steps.size:
            continue
        obs = torch.from_numpy(batch["obs"][k][steps])
        t = torch.from_numpy((t0[lane] + steps).astype(np.int32))
        keys = buffer.step_keys_plain(te._exp["key"][lane].expand(
            len(steps), 2), t)
        noise = rnd.gumbel(keys, (4,))
        with torch.no_grad():
            z = net(obs, flat)[0] + noise
        top = torch.topk(z, 2, dim=-1).values
        out.append(float((top[:, 0] - top[:, 1]).min()))
    return min(out) if out else float("inf")


def test_schedule_matches_reference(envs, capsys):
    """The numpy-seeded schedule: admissions (fresh lanes and reuse of
    retired ones), interactive ticks, bursts under every table entry,
    drains after each burst."""
    je, te = engine_pair(envs)
    assert te.policy_names == je.policy_names
    assert te.policy_ids == je.policy_ids
    rng = np.random.default_rng(2024)
    names = te.policy_names
    owner = {}  # lane -> "policy" id or "interactive"
    margin = float("inf")
    next_seed = 100
    for rnd_i in range(10):
        free = [ln for ln in range(N_LANES) if ln not in owner]
        admit = {}
        for ln in free:
            if rng.random() < 0.8:
                admit[ln] = next_seed
                next_seed += 1
                owner[ln] = ("interactive" if rng.random() < 0.25
                             else int(rng.integers(len(names))))
        oj, ot = je.splice(admit), te.splice(admit)
        assert oj.keys() == ot.keys()
        for ln in oj:
            assert_obs(ot[ln], oj[ln], f"round {rnd_i} splice lane {ln}")
        acts = {ln: int(rng.integers(4)) for ln, o in owner.items()
                if o == "interactive"}
        if acts:
            rj, rt = je.tick(acts), te.tick(acts)
            for ln in acts:
                assert_obs(rt[ln]["obs"], rj[ln]["obs"], f"tick {ln}")
                assert rt[ln]["reward"] == rj[ln]["reward"]
                assert rt[ln]["done"] == rj[ln]["done"]
                for k, v in rj[ln]["info"].items():
                    assert rt[ln]["info"][k] == pytest.approx(
                        v, rel=1e-6, abs=1e-6), k
                if rj[ln]["done"]:
                    del owner[ln]
        lanes = {ln: o for ln, o in owner.items() if o != "interactive"}
        t0 = te._exp["t"].numpy().copy()
        bj, bt = je.burst_run(lanes), te.burst_run(lanes)
        if lanes:
            assert_regs(bt, bj, f"round {rnd_i} burst")
            for ln in lanes:
                if bj["done"][ln]:
                    del owner[ln]
        else:
            assert bj is None and bt is None
        dj, dt = je.drain_experience(), te.drain_experience()
        assert_batch(dt, dj, f"round {rnd_i} drain")
        if dj is not None:
            margin = min(margin, sample_margins(te, t0, dt))
        assert_obs(te._carry[1], je._carry[1], f"round {rnd_i} carry obs")
        for f in ("a", "h", "event", "match_h", "steps", "n_activations"):
            np.testing.assert_array_equal(
                getattr(te._carry[0], f).numpy(),
                np.asarray(getattr(je._carry[0], f)), err_msg=f)
    assert margin > 1e-5
    rj, rt = je.report(), te.report()
    for k in ("steps", "episodes", "bursts", "ticks", "admitted",
              "samples", "policies"):
        assert rt[k] == rj[k], k
    with capsys.disabled():
        print(f"\n[serve engine] smallest sampled-action margin {margin:.3g}")


def test_burst_admission_matches_reference(envs):
    """`burst_run(admit=)`, the server's admission of policy sessions with
    their first burst (some admitted lanes run, some are held), against
    the reference's `splice` then `burst_run`: registers, drained rings,
    carry and counters."""
    je, te = engine_pair(envs)
    rng = np.random.default_rng(77)
    names = te.policy_names
    running, seed = {}, 300
    for rnd_i in range(8):
        admit = {}
        for ln in range(N_LANES):
            if ln not in running and rng.random() < 0.8:
                admit[ln], seed = seed, seed + 1
                if rng.random() < 0.75:
                    running[ln] = int(rng.integers(len(names)))
        je.splice(admit)
        bj = je.burst_run(dict(running))
        bt = te.burst_run(dict(running), admit=admit)
        if running:
            assert_regs(bt, bj, f"round {rnd_i} burst")
            for ln in [ln for ln in running if bj["done"][ln]]:
                del running[ln]
        else:
            assert bj is None and bt is None
        assert_batch(te.drain_experience(), je.drain_experience(),
                     f"round {rnd_i} drain")
        assert_obs(te._carry[1], je._carry[1], f"round {rnd_i} carry obs")
        for f in ("a", "h", "event", "match_h", "steps", "n_activations"):
            np.testing.assert_array_equal(
                getattr(te._carry[0], f).numpy(),
                np.asarray(getattr(je._carry[0], f)), err_msg=f)
    rj, rt = je.report(), te.report()
    for k in ("steps", "episodes", "bursts", "admitted", "samples"):
        assert rt[k] == rj[k], k


def test_burst_replays_rollout(envs):
    """A spliced lane's first completed episode in the burst carries the
    aggregates of `rollout(PRNGKey(S))`, in both packages."""
    jenv, tenv = envs
    jp, tp = params_pair()
    te = ResidentEngine(tenv, tp, n_lanes=N_LANES, burst=BURST,
                        device="cpu")
    te.start()
    hid = te.policy_ids["honest"]
    seeds = {0: 5, 2: 9}
    obs0 = te.splice(seeds)
    bursts = [te.burst_run({ln: hid for ln in seeds})
              for _ in range(3 * MAX_STEPS // BURST)]
    for lane, seed in seeds.items():
        obs, _, _, done, info = jenv.rollout(
            jax.random.PRNGKey(seed), jp, jenv.policies["honest"],
            MAX_STEPS + 1)
        tobs, _, _, tdone, tinfo = tenv.rollout(
            rnd.PRNGKey(seed, device="cpu"), tp, "honest", MAX_STEPS + 1)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(done))
        assert_obs(obs0[lane], np.asarray(obs)[0], f"lane {lane} obs0")
        assert_obs(obs0[lane], tobs[0].numpy(), f"lane {lane} obs0")
        b = next(i for i, o in enumerate(bursts) if o["done"][lane])
        idx = b * BURST + int(bursts[b]["done_step"][lane])
        s_idx = int(np.argmax(np.asarray(done)))
        assert idx == s_idx
        for k in ("episode_reward_attacker", "episode_reward_defender",
                  "episode_progress", "episode_n_steps"):
            assert bursts[b][k][lane] == float(np.asarray(info[k])[s_idx])
            assert bursts[b][k][lane] == float(tinfo[k][s_idx])
    rep = te.report()
    assert rep["steps"] == len(seeds) * 3 * MAX_STEPS
    assert rep["bursts"] == 3 * MAX_STEPS // BURST


def test_swap_keeps_other_lanes_and_refuses_other_trees(envs):
    _, tenv = envs
    _, tp = params_pair()
    _, _, tnet = nets(42)
    _, _, tnet2 = nets(43)

    def engine():
        e = ResidentEngine(tenv, tp, n_lanes=N_LANES, burst=BURST,
                           swap_policies={"ppo": (tnet, tnet.flat.detach()
                                                  .clone(), "fp0")},
                           sample_policies=("ppo",), experience=BURST,
                           device="cpu")
        e.start()
        e.splice({ln: 100 + ln for ln in range(N_LANES)})
        return e

    a, b = engine(), engine()
    ids = {0: a.policy_ids["honest"], 1: a.policy_ids["simple"],
           2: a.policy_ids["ppo"], 3: a.policy_ids["ppo#sample"]}
    out_a, out_b = a.burst_run(ids), b.burst_run(ids)
    assert_regs(out_b, out_a, "before the swap")
    swapped = b.swap_policy("ppo", tnet2.flat.detach(), fingerprint="fp2")
    assert swapped == {"swapped": True, "fingerprint": "fp2"}
    assert b.policy_fingerprint("ppo") == "fp2" and b.swaps == 1
    out_a2, out_b2 = a.burst_run(ids), b.burst_run(ids)
    for lane in (0, 1):  # the scripted lanes: bit for bit unperturbed
        for k in BURST_FIELDS:
            assert out_a2[k][lane] == out_b2[k][lane], (k, lane)
    for f in ("a", "h", "steps", "key"):
        np.testing.assert_array_equal(getattr(a._carry[0], f)[:2].numpy(),
                                      getattr(b._carry[0], f)[:2].numpy())
    # an identical fingerprint is a no-op
    out = b.swap_policy("ppo", tnet.flat.detach(), fingerprint="fp2")
    assert out["swapped"] is False and out["reason"] == "identical"
    assert b.swaps == 1
    # another tree: other widths, or another length, is refused typed
    other = ActorCritic(4, 4, (12,), device="cpu")
    with pytest.raises(IntegrityError) as e:
        b.swap_policy("ppo", other, fingerprint="fp-bad")
    assert e.value.reason == "version"
    with pytest.raises(IntegrityError):
        b.swap_policy("ppo", torch.zeros(7), fingerprint="fp-bad")
    assert b.policy_fingerprint("ppo") == "fp2"
    # the same widths as a net is accepted
    assert b.swap_policy("ppo", tnet, fingerprint="fp3")["swapped"]
    with pytest.raises(ValueError, match="swappable"):
        b.swap_policy("nope", tnet.flat)


def test_tailstorm_plain_burst_matches_reference():
    """The plain burst is generic over `_lane_step`: a DAG env's burst
    (Tailstorm k=2 in a 40-slot ring, every scripted policy) against the
    reference's."""
    key, kw = "tailstorm-2-discount-heuristic", dict(window=40)
    jenv = jregistry.get(key, **kw)
    tenv = tregistry.get(key, **kw)
    jp, tp = params_pair(alpha=0.33)
    je = JEngine(jenv, jp, n_lanes=N_LANES, burst=BURST)
    te = ResidentEngine(tenv, tp, n_lanes=N_LANES, burst=BURST,
                        device="cpu")
    assert te.policy_names == je.policy_names
    je.start()
    te.start()
    admit = {ln: 30 + ln for ln in range(N_LANES)}
    oj, ot = je.splice(admit), te.splice(admit)
    for ln in admit:
        assert_obs(ot[ln], oj[ln], f"splice {ln}")
    n = len(te.policy_names)
    for r in range(2 * MAX_STEPS // BURST + 1):
        lanes = {ln: (ln + r) % n for ln in range(N_LANES)}
        assert_regs(te.burst_run(lanes), je.burst_run(lanes), f"burst {r}")
        assert_obs(te._carry[1], je._carry[1], f"burst {r} obs")


def test_card_refusals_name_their_items(envs, monkeypatch):
    """Refusals that happen before any tensor is made, so they are
    checked here without a card: mesh=, device metrics; the extra-policy
    and table limits of K14, and K14-dag's net and shared-memory limits
    (a DAG env's engine on "cuda" builds, its table checked)."""
    _, tenv = envs
    _, tp = params_pair()
    dag = tregistry.get("tailstorm-2-discount-heuristic", window=40)
    eng = ResidentEngine(dag, tp, n_lanes=4, device="cuda")
    assert eng.on_card and eng.env.burst_kernel_name == "K14-dag"
    _, _, tnet = nets(1)  # one hidden layer: not K11-act's warp MLP
    with pytest.raises(NotImplementedError, match="K14-dag runs nets"):
        ResidentEngine(dag, tp, n_lanes=4, device="cuda",
                       swap_policies={"ppo": (tnet, tnet.flat, None)})
    wide = ActorCritic(dag.observation_length, dag.n_actions, (128, 128),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="K14-dag"):
        ResidentEngine(dag, tp, n_lanes=4, device="cuda",
                       extra_policies={"w": NetPolicy(wide)})
    with pytest.raises(NotImplementedError, match="K14-dag"):
        ResidentEngine(dag, tp, n_lanes=4, device="cuda",
                       extra_policies={"f": lambda o: o[..., 0]})
    # four nets of 16 inputs, hidden 96 and 24 actions beside K9's
    # full-mode scratch pass a block's shared memory; the card reports
    # K14-dag's static shared memory, here its layout: the lanes' params
    # (4 x 24 bytes) and K9's QScratch (64 candidates' five arrays, three
    # of 544 slots) for each of a block's four warps
    k9_full = 4 * 24 + 4 * (64 * (4 + 8 + 4 + 4) + 3 * 4 * 544)
    smem = lambda: (k9_full, kernels.SMEM_PER_BLOCK)  # noqa: E731
    big = ActorCritic(16, 24, (96, 96), device="cpu")
    with pytest.raises(NotImplementedError, match="K14-dag holds"):
        kernels.check_dag_burst_nets([big] * 4, 24, 16, smem)
    kernels.check_dag_burst_nets([big] * 3, 24, 16, smem)
    # Nakamoto's K14 keeps thread mode's limit of 4 actions
    eth = tregistry.get_sized("ethereum-byzantium", 16)
    eth_net = ActorCritic(eth.observation_length, eth.n_actions, (64, 64),
                          device="cpu")
    kernels.check_dag_burst_nets([eth_net], eth.n_actions,
                                 eth.observation_length,
                                 lambda: (4 * 24, kernels.SMEM_PER_BLOCK))
    with pytest.raises(NotImplementedError, match="at most 4 actions"):
        kernels.check_burst_nets([eth_net], eth.n_actions)
    with pytest.raises(NotImplementedError, match="item 13"):
        ResidentEngine(tenv, tp, n_lanes=4, mesh=object(), device="cpu")
    # CPR_DEVICE_METRICS=1 builds (K17 ported); its cells:
    # tests/test_torch_device_metrics.py
    monkeypatch.setenv("CPR_DEVICE_METRICS", "1")
    ResidentEngine(tenv, tp, n_lanes=4, device="cpu")
    monkeypatch.delenv("CPR_DEVICE_METRICS")
    with pytest.raises(NotImplementedError, match="K14"):
        ResidentEngine(tenv, tp, n_lanes=4, device="cuda",
                       extra_policies={"f": lambda o: o[..., 0]})
    _, _, tnet = nets(1)  # one hidden layer: not K11-act's thread MLP
    with pytest.raises(NotImplementedError, match="two equal hidden"):
        ResidentEngine(tenv, tp, n_lanes=4, device="cuda",
                       swap_policies={"ppo": (tnet, tnet.flat, None)})
    with pytest.raises(ValueError, match="experience plane"):
        ResidentEngine(tenv, tp, n_lanes=4, device="cpu",
                       swap_policies={"ppo": (tnet, tnet.flat, None)},
                       sample_policies=("ppo",))
