"""Port parity of the Sdag env (`cpr_tpu_torch.envs.sdag`, the plain twin
of K10-sdag) against cpr_tpu on the CPU, with the tolerances and helpers
of tests/test_torch_bk.py: every carry field bit-identical (stale ring
rows and the `stale` plane included), clocks to rtol 1e-5, unit
observations to atol 1e-6, rewards exact — the discount scheme's
fractional rewards too, whose sum follows XLA:CPU's order (the ULP gap
is printed, and must be 0). The grid covers k = 4 under both incentive
schemes and both sub-block selections and k = 8 discount-heuristic (the
shipped config's protocol), in ring mode (window 128, a 32-slot ring
that wraps, the 48-slot ring of tests/test_dag_ring.py) and in full
mode, under every policy; the reward-density heuristic and the block
reward are held alone on seeded frames, density ties included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.sdag import SdagSSZ as JEnv
from cpr_tpu.params import make_params as jmake
from cpr_tpu_torch import convert
from cpr_tpu_torch.envs import quorum as Q
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.sdag import SdagSSZ as TEnv
from cpr_tpu_torch.envs.sdag import select_heuristic
from cpr_tpu_torch.params import make_params as tmake
from test_torch_bk import (assert_state, assert_stats_drivers, assert_stream,
                           jax_state_numpy, jax_streams, keys, params,
                           step_lanes_trace)

LANES, STEPS, MAX_STEPS = 12, 80, 36
CONFIGS = {
    "ring128-k8-discount-heuristic": dict(k=8, incentive_scheme="discount",
                                          window=128),
    "ring32-k4-constant-heuristic": dict(k=4, window=32),
    "ring32-k4-discount-altruistic": dict(k=4, incentive_scheme="discount",
                                          subblock_selection="altruistic",
                                          window=32),
    "full-k4-discount-heuristic": dict(k=4, incentive_scheme="discount",
                                       max_steps_hint=40),
    "full-k4-constant-altruistic": dict(k=4, subblock_selection="altruistic",
                                        max_steps_hint=40),
}
STATS_POLICIES = {"ring128-k8-discount-heuristic": ("override-catchup",),
                  "full-k4-constant-altruistic": ("avoid-loss",)}
POLICIES = ("honest", "release-block", "override-block", "override-catchup",
            "minor-delay", "avoid-loss")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins run thousands of tiny ops a step: one thread each
    keeps parallel test workers (pytest-xdist) from oversubscribing the
    cores (restored after the module)."""
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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def streams(request):
    kw = CONFIGS[request.param]
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=MAX_STEPS)
    jk, tk = keys(3, LANES)
    run = jax_streams(jenv, jp, jk, STEPS)
    want = {name: run(i) for i, name in enumerate(tenv.scripted_policies)}
    return request.param, jenv, tenv, tp, tk, want


@pytest.mark.parametrize("policy", POLICIES)
def test_streams_every_policy(streams, policy):
    name, jenv, tenv, tp, tk, want = streams
    assert tenv.capacity == jenv.capacity and tenv.ring == jenv.ring
    nd = assert_stream(tenv, tp, tk, want[policy], policy, STEPS,
                       f"{name} {policy}")
    assert int(nd.min()) >= 2  # the logical reset fired on every lane
    if policy in STATS_POLICIES.get(name, ()):
        assert_stats_drivers(tenv, tp, tk, want[policy],
                             tenv.policies[policy], STEPS, 33)
    if policy == POLICIES[-1]:
        finals = [w[0][0] for w in want.values()]
        if name.startswith("ring32"):
            # an episode appended more than 32 vertices (the root and one
            # a mining draw): the ring wrapped
            acts = [np.asarray(w[3][4]["episode_n_activations"])[
                np.asarray(w[3][3])] for w in want.values()]
            assert max(a.max() for a in acts) + 1 > 32
        if name.startswith("full"):
            # Adopts left stale vertices
            assert any(np.asarray(s.stale).any() for s in finals)
        if "discount" in name:
            # blocks paid fractional rewards
            r = np.stack([np.asarray(w[3][4]["step_reward_defender"])
                          for w in want.values()])
            assert (r != np.round(r)).any()


def test_wrapping_ring_equals_full_mode():
    """tests/test_dag_ring.py's case: a 48-slot ring at k = 4 wraps every
    96-step episode and replays full mode bit for bit, in the port as in
    cpr_tpu (block_lca's walk against the chain plane); the port's ring
    against cpr_tpu's."""
    jp, tp = (jmake(alpha=0.3, gamma=0.5, max_steps=96),
              tmake(alpha=0.3, gamma=0.5, max_steps=96))
    jk, tk = keys(6, 16)
    jring = JEnv(k=4, max_steps_hint=104, window=48)
    want = jax.jit(jax.vmap(lambda k: jring.episode_stats(
        k, jp, jring.policies["override-catchup"], 104)))(jk)
    got = {}
    for env in (TEnv(k=4, max_steps_hint=104),
                TEnv(k=4, max_steps_hint=104, window=48)):
        got[env.ring] = env.make_episode_stats_fn(
            tp, env.policies["override-catchup"], 104)(tk)
    for key in sorted(want):
        np.testing.assert_array_equal(got[False][key].numpy(),
                                      got[True][key].numpy(), err_msg=key)
        if "time" in key:  # the clocks: log1p, rtol 1e-5
            np.testing.assert_allclose(got[True][key].numpy(),
                                       np.asarray(want[key]), rtol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[True][key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
    assert int(np.asarray(want["n_episodes"]).min()) >= 1


@pytest.mark.parametrize("window", [32, None])
def test_step_lanes_and_mid_episode_convert(window):
    kw = dict(k=3, incentive_scheme="discount", window=window,
              max_steps_hint=40)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=12)
    assert step_lanes_trace(jenv, tenv, jp, tp, 7, 12, 30, convert_at=15) > 0


def random_frames(seed, L, k):
    """Seeded candidate frames of Sdag at k (C = 4k + 16): votes with up to
    k-1 parents among older candidates, their closures, invalid
    candidates with their descendants, own flags and a miner plane. Half
    the lanes hold only parentless votes of one owner, whose densities
    tie."""
    C = 4 * k + 16
    rng = np.random.default_rng(seed)
    abits = np.zeros((L, C, C), bool)
    for i in range(C):
        abits[:, i, i] = True
        for _ in range(k - 1):
            p = rng.integers(0, max(i, 1), L)
            take = (rng.random(L) < 0.35) & (i > 0)
            take[: L // 2] = False
            abits[take, i] |= abits[take, p[take]]
    n = rng.integers(1, C + 1, L)
    cvalid = np.arange(C)[None, :] < n[:, None]
    bad = (rng.random((L, C)) < 0.05) & cvalid
    bad = (abits & bad[:, None, :]).any(2)
    cvalid &= ~bad
    abits &= cvalid[:, :, None]
    own = rng.random((L, C)) < 0.5
    own[: L // 2] = True
    miner = rng.integers(0, 2, (L, C)).astype(np.int32)
    return C, cvalid, abits, own, miner


def port_frame(cvalid, abits):
    L, C = cvalid.shape
    cidx = torch.arange(C, dtype=torch.int32).expand(L, C).contiguous()
    t = torch.from_numpy
    return Q.Frame(cidx, torch.ones((L, C), dtype=torch.bool), t(cvalid),
                   t(abits))


@pytest.mark.parametrize("k", [3, 8])
def test_select_heuristic_on_seeded_frames(k):
    """The reward-density greedy alone against cpr_tpu's `_select_heuristic`
    on seeded frames; lanes whose first round has tied densities (before
    the arange * 1e-7 tiebreak) are counted and must occur."""
    L = 512
    C, cvalid, abits, own, _ = random_frames(k, L, k)
    jenv = JEnv(k=k, window=128)
    cidx = np.broadcast_to(np.arange(C, dtype=np.int32), (L, C))
    S, n = jax.jit(jax.vmap(jenv._select_heuristic))(
        jnp.asarray(cidx), jnp.asarray(cvalid), jnp.asarray(abits),
        jnp.asarray(own))
    f = port_frame(cvalid, abits)
    tS, tn = select_heuristic(f, torch.from_numpy(own), k - 1)
    np.testing.assert_array_equal(tS.numpy(), np.asarray(S))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n))
    # first-round ties: every eligible candidate's raw density
    A = abits.astype(np.float32)
    Sf = abits.astype(np.float32)  # S' of each candidate from S = {}
    ownf = (own & cvalid).astype(np.float32)[:, None, :]
    mrt = ((Sf @ A + Sf @ A.transpose(0, 2, 1) - 1) * ownf * Sf).sum(2)
    size = abits.sum(2)
    dens = np.where(cvalid & (size <= k - 1), mrt / np.maximum(size, 1),
                    -np.inf)
    top = dens.max(1, keepdims=True)
    ties = int(((dens == top) & np.isfinite(top)).sum(1).__gt__(1).sum())
    full = int((np.asarray(n) == k - 1).sum())
    print(f"sdag heuristic k={k}: {L} lanes, {ties} with first-round "
          f"density ties, {full} full selections")
    assert ties > 0 and full > 0


class _Miners:
    def __init__(self, miner):
        self.miner = miner


@pytest.mark.parametrize("k", [4, 8])
def test_discount_block_reward_on_seeded_frames(k):
    """block_reward under the discount scheme against cpr_tpu's on seeded
    frames and selections: C = 32 sums in one run, C = 48 in XLA's two
    windows; the ULP gap is printed and must be 0."""
    L = 2048
    C, cvalid, abits, _, miner = random_frames(100 + k, L, k)
    rng = np.random.default_rng(k)
    S = np.zeros((L, C), bool)
    for lane in range(L):
        pick = rng.choice(C, size=rng.integers(1, k), replace=False)
        S[lane] = abits[lane, pick].any(0)
    jenv = JEnv(k=k, incentive_scheme="discount", window=128)
    tenv = TEnv(k=k, incentive_scheme="discount", window=128)
    cidx = np.broadcast_to(np.arange(C, dtype=np.int32), (L, C))
    who = rng.integers(0, 2, L).astype(np.int32)

    def jr(cidx, cvalid, abits, S, miner, who):
        return jenv.block_reward(_Miners(miner), (cidx, cvalid, abits, S),
                                 who)

    want = jax.jit(jax.vmap(jr))(*(jnp.asarray(a) for a in (
        cidx, cvalid, abits, S, miner, who)))
    got = tenv.block_reward(_Miners(torch.from_numpy(miner)),
                            port_frame(cvalid, abits), torch.from_numpy(S),
                            torch.from_numpy(who))
    gap = 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        gap = max(gap, int(np.abs(g.numpy().view(np.int32)
                                  - w.view(np.int32)).max()))
    frac = int((np.asarray(want[0]) != np.round(np.asarray(want[0]))).sum())
    print(f"sdag discount reward k={k} (C={C}): {L} lanes, {frac} "
          f"fractional, ULP gap {gap}")
    assert frac > 0 and gap == 0


def test_convert_carries_a_jax_state():
    """convert.dag_state_from_numpy carries a mid-episode cpr_tpu Sdag
    state (the `stale` plane included) across whole, and the port steps
    on from it as cpr_tpu does."""
    kw = dict(k=4, window=32)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=30)
    jk, _ = keys(12, 8)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    js = jenv.reset_lanes(jk, jp)[0]
    for t in range(20):
        js = jstep(js, jnp.full(8, 7 if t % 5 else 4, jnp.int32))[0]
    ts = convert.dag_state_from_numpy(tenv, jax_state_numpy(js),
                                      device="cpu")
    assert_state(ts, js, "converted")
    a = np.full(8, 5, np.int32)
    assert_state(tenv.step(ts, torch.from_numpy(a), tp)[0],
                 jstep(js, jnp.asarray(a))[0], "stepped")


def test_policies_match_reference_on_observations():
    from cpr_tpu import obs as jobs
    for unit in (True, False):
        jenv, tenv = JEnv(k=4, unit_observation=unit), TEnv(
            k=4, unit_observation=unit)
        rng = np.random.default_rng(int(unit))
        n = 400
        ints = np.stack([rng.integers(0, 14, n), rng.integers(0, 14, n),
                         rng.integers(-14, 14, n), rng.integers(0, 9, n),
                         rng.integers(0, 9, n), rng.integers(0, 9, n),
                         rng.integers(0, 2, n)])
        obs = np.asarray(jobs.encode(jenv.fields, tuple(jnp.asarray(v)
                                                        for v in ints),
                                     unit))
        for name in tenv.scripted_policies:
            want = np.asarray(jax.vmap(jenv.policies[name])(obs))
            got = tenv.policies[name](torch.from_numpy(obs.copy()))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            pid = tenv.scripted_policy_id(name)
            t = [torch.from_numpy(v.astype(np.int32)) for v in ints]
            np.testing.assert_array_equal(
                tenv._policy_ints(pid, t[0], t[1], t[3], t[4]).numpy(), want)
    assert tuple(jenv.policies) == tenv.scripted_policies


def test_registry_keys():
    for key in ("sdag-8-discount-heuristic", "sdag-4-constant-altruistic"):
        env, jenv = tregistry.get(key, window=128), jregistry.get(
            key, window=128)
        assert isinstance(env, TEnv)
        assert (env.k, env.q, env.incentive_scheme, env.subblock_selection,
                env.capacity, env.max_parents, env.C_MAX, env.release_scan) \
            == (jenv.k, jenv.q, jenv.incentive_scheme,
                jenv.subblock_selection, jenv.capacity, jenv.max_parents,
                jenv.C_MAX, jenv.release_scan)
        assert tregistry.describe(key) == jregistry.describe(key)


def test_kernels_take_ring_windows_only():
    """Full mode and frames beyond 64 candidates raise on CUDA, naming
    what is queued, before any launch."""
    for env, match in ((TEnv(k=4), "full mode .* item 8c"),
                       (TEnv(k=13, window=128),
                        "candidate frames of at most"),
                       (TEnv(k=8, window=128), None)):
        if match is None:
            env._check_kernel()
            continue
        with pytest.raises(NotImplementedError, match=match):
            env._empty_carry(4, "cpu")


def test_shipped_config_builds_and_trains():
    """The shipped sdag-8-discount.yaml: build_env sizes full mode as
    cpr_tpu does on the CPU and gives the kernels' 128-slot ring on the
    card; a small run of its config trains on the CPU with finite
    metrics."""
    from pathlib import Path

    from cpr_tpu.train import config as jconfig
    from cpr_tpu.train import driver as jdriver
    from cpr_tpu_torch.train import config as tconfig
    from cpr_tpu_torch.train import driver as tdriver
    path = Path(jconfig.__file__).parent / "configs" / "sdag-8-discount.yaml"
    cfg = tconfig.TrainConfig.from_yaml(str(path))
    jenv = jdriver.build_env(jconfig.TrainConfig.from_yaml(str(path))).inner
    full, ring = (tdriver.build_env(cfg, d).inner for d in ("cpu", "cuda"))
    assert isinstance(full, TEnv) and not full.ring
    assert full.capacity == jenv.capacity == 136
    assert (full.incentive_scheme, full.subblock_selection) == (
        "discount", "heuristic")
    assert ring.ring and ring.capacity == tdriver.CUDA_DAG_WINDOW
    small = tconfig.TrainConfig.from_dict(dict(
        protocol=cfg.protocol, alpha=dict(min=0.15, max=0.45), gamma=0.5,
        episode_len=16, n_envs=8, reward=cfg.reward,
        ppo=dict(n_steps=8, n_minibatches=2, update_epochs=1, layer_size=8),
        eval=dict(freq=1, start_at_iteration=0, episodes_per_alpha=2)))
    _, history, rows = tdriver.train_from_config(small, n_updates=1,
                                                 device="cpu")
    assert len(history) == 1 and rows
    assert all(np.isfinite(v) for v in history[0].values()
               if isinstance(v, float))
