"""Port parity of the serve engine over Tailstorm against cpr_tpu's on
the CPU (the schedule and its checks are test_torch_serve_dag_a.py's):
Tailstorm k = 2 in full mode and in a 40-slot ring, and with the
learning plane: rings, a loaded greedy net, the swappable net
`ppo` and `ppo#sample` (JAX's nets, carried across by `convert`), every
burst drained and held to the reference, a mid-run swap; the smallest
sampled-action margin is printed.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from cpr_tpu.train.ppo import ActorCritic as JNet  # noqa: E402
from cpr_tpu_torch import convert  # noqa: E402
from cpr_tpu_torch import random as rnd  # noqa: E402
from cpr_tpu_torch.learn import buffer  # noqa: E402
from cpr_tpu_torch.train.ppo import ActorCritic, NetPolicy  # noqa: E402
from test_torch_serve_dag_a import (BURST, KEYS, RING,  # noqa: E402
                                    check_family, engine_pair, env_pair,
                                    run_schedule)
from test_torch_serve_engine import assert_batch  # noqa: E402

HIDDEN = (8,)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("window", [0, RING], ids=["full", "ring"])
def test_schedule_matches_reference(window):
    check_family("ts", window, 31 + window)


def nets(env, seed):
    """A JAX ActorCritic's params for `env` and the port's net holding
    them."""
    jnet = JNet(env.n_actions, HIDDEN)
    p = jax.device_get(jnet.init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, env.observation_length))))
    tnet = ActorCritic(env.observation_length, env.n_actions, HIDDEN,
                       device="cpu")
    with torch.no_grad():
        tnet.flat.copy_(convert.actor_critic_from_flax(
            jax.tree.map(np.asarray, p), "cpu"))
    return jnet, p, tnet


def sample_margins(te, t0, batch):
    """Smallest gap between the two largest perturbed logits of every
    `ppo#sample` step of a drained burst: where it exceeds ~1e-6 the two
    packages' draws agree."""
    sid = te.policy_ids["ppo#sample"]
    net, flat = te._slots[te._slot_of["ppo"]]
    A = te.env.n_actions
    out = []
    for k, lane in enumerate(batch["lanes"]):
        steps = np.nonzero(batch["policy"][k] == sid)[0]
        if not steps.size:
            continue
        obs = torch.from_numpy(batch["obs"][k][steps])
        t = torch.from_numpy((t0[lane] + steps).astype(np.int32))
        keys = buffer.step_keys_plain(te._exp["key"][lane].expand(
            len(steps), 2), t)
        with torch.no_grad():
            z = net(obs, flat)[0] + rnd.gumbel(keys, (A,))
        top = torch.topk(z, 2, dim=-1).values
        out.append(float((top[:, 0] - top[:, 1]).min()))
    return min(out) if out else float("inf")


def test_learning_plane_matches_reference(capsys):
    """Tailstorm in full mode with the rings (capacity = burst), a loaded
    greedy net, `ppo` and `ppo#sample`: the schedule with every burst
    drained and held to the reference's drain, `ppo` swapped for another
    net after the third round in both packages."""
    jenv, tenv = env_pair(KEYS["ts"], 0)
    jnet, p, tnet = nets(tenv, 42)
    jnet2, p2, tnet2 = nets(tenv, 7)
    _, p3, tnet3 = nets(tenv, 9)
    je, te = engine_pair(
        KEYS["ts"], 0,
        extra_policies={"loaded": NetPolicy(tnet2)},
        swap_policies={"ppo": (tnet, tnet.flat.detach().clone(), "fp0")},
        sample_policies=("ppo",), experience=BURST,
        jkw=dict(extra_policies={"loaded": lambda o: jnp.argmax(
                     jnet2.apply(p2, o)[0])},
                 swap_policies={"ppo": (lambda w, o: jnet.apply(w, o)[0],
                                        p, "fp0")},
                 sample_policies=("ppo",), experience=BURST))
    margin, drains, rounds = [float("inf")], [0], [0]

    def drain(je, te, t0):
        dj, dt = je.drain_experience(), te.drain_experience()
        assert_batch(dt, dj, f"round {rounds[0]} drain")
        if dj is not None:
            drains[0] += 1
            margin[0] = min(margin[0], sample_margins(te, t0, dt))
        rounds[0] += 1
        if rounds[0] == 3:
            assert je.swap_policy("ppo", p3, fingerprint="fp1")["swapped"]
            assert te.swap_policy("ppo", tnet3.flat.detach(),
                                  fingerprint="fp1")["swapped"]

    run_schedule(je, te, 71, drain=drain)
    assert drains[0] > 0 and te.swaps == 1
    assert margin[0] > 1e-5
    with capsys.disabled():
        print(f"\n[serve dag] smallest sampled-action margin {margin[0]:.3g}")
