"""Port parity of the block-DAG substrate (`cpr_tpu_torch.core.dag`, the
plain twin of K8) against cpr_tpu.core.dag on the CPU.

A numpy-seeded register-machine script (`core.dag.make_script`: appends,
releases, retirements and every query the bk and Ethereum envs use, and
in a second script the Tailstorm and Stree envs' `last_by_age` and
`descendants_mask`) runs
through the reference (vmapped over lanes, one `lax.switch` per op in a
`lax.scan`) and through `script_plain`: in ring mode with ancestry
planes on a window small enough to wrap and overflow, and in full mode
with and without binary lifting (the walk-based queries). Every result,
the registers and the whole final DAG must be equal bit for bit: the
script's times and rewards are small integers, exact in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.core import dag as JD
from cpr_tpu_torch.core import dag as D

L, T, P = 16, 240, 3
# name: (capacity, ring, masks, lift, ops). Full mode holds every append
# (a full DAG pins further appends to its last slot, where a parent
# register may name that slot and the walks would cycle, in the reference
# as here); the ring wraps and overflows.
MODES = {
    "ring": (24, True, True, False, D.RING_OPS),
    # the vote-quorum envs' queries (last_by_age, descendants_mask)
    "ring-q": (24, True, True, False, D.RING_OPS_Q),
    "full": (T, False, False, False, D.FULL_OPS),
    "full-lift": (T, False, False, True, D.FULL_OPS),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins run thousands of tiny ops a step: one thread each
    keeps parallel test workers (pytest-xdist) from oversubscribing the
    cores (restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_script(capacity, ring, masks, lift, allowed, ops, args, fargs):
    """The script through cpr_tpu.core.dag; returns (dag, regs, out) with
    a leading lane axis (out [T, L, 4])."""
    K = D.SCRIPT_TOPK
    i32 = jnp.int32

    def reg(regs, i):
        return jnp.where(i >= 0, regs[jnp.maximum(i, 0)], -1)

    def hreg(dag, r):
        return jnp.where(r >= 0, dag.height[jnp.maximum(r, 0)], 0)

    def visible(dag):
        return (dag.vis_d & dag.exists()).sum().astype(i32)

    def out4(*v):
        v = list(v) + [0] * (4 - len(v))
        return jnp.stack([jnp.asarray(x, i32) for x in v])

    def op_fn(op):
        def fn(dag, regs, a, f):
            x, y = reg(regs, a[0]), reg(regs, a[1])
            if op == D.OP_APPEND:
                parents = jnp.stack([reg(regs, a[8 + p]) for p in range(P)])
                height = hreg(dag, parents[0]) + a[3]
                base = jnp.where(parents[0] >= 0,
                                 dag.cum_prog[jnp.maximum(parents[0], 0)],
                                 0.0) + 1.0
                progress = jnp.where(a[7] != 0,
                                     (height * 2).astype(jnp.float32), base)
                dag, idx = JD.append_if(
                    dag, a[0] != 0, parents, kind=a[2], height=height,
                    vis_d=a[4] != 0, miner=a[5], aux=a[6], time=f[0],
                    reward_atk=f[1], reward_def=f[2], pow_hash=f[3],
                    progress=progress)
                return dag, regs.at[a[1]].set(idx), out4(idx, dag.n,
                                                         dag.overflow)
            if op == D.OP_RELEASE_MASKED:
                dag = JD.release_masked(dag, x, f[0])
                return dag, regs, out4(visible(dag))
            if op == D.OP_SELECT_VIS:
                dag = JD.select_vis(a[1] != 0,
                                    JD.release_masked(dag, x, f[0]), dag)
                return dag, regs, out4(visible(dag))
            if op == D.OP_RELEASE_TOPK:
                idx, valid = JD.top_k_by(dag.born_at,
                                         JD.children0_mask(dag, x), K)
                take = jnp.arange(K) < a[1]
                dag = JD.release(dag, JD.mask_of(idx, valid & take,
                                                 capacity), f[0])
                return dag, regs, out4(visible(dag), valid.sum())
            if op == D.OP_RETIRE:
                if ring:
                    dag = JD.retire_below(dag, jnp.where(
                        x >= 0, dag.gid[jnp.maximum(x, 0)], 0))
                dropped = JD.drop_if_retired(dag, y)
                return (dag, regs.at[jnp.maximum(a[1], 0)].set(dropped),
                        out4(dag.live_floor, dropped))
            if op == D.OP_TOPK:
                idx, valid = JD.top_k_by(dag.born_at, dag.exists()
                                         & (dag.kind == a[1]), K)
                return dag, regs, out4(jnp.where(valid, idx, 0).sum(),
                                       valid.sum(), idx[0], idx[-1])
            if op == D.OP_COUNTS:
                ex = dag.exists()
                return dag, regs, out4(
                    ex.sum(), (JD.newer_than(dag, x) & ex).sum(),
                    JD.children0_mask(dag, x).sum(), JD.first_by_age(dag, ex))
            if op == D.OP_DESCENDANTS:
                m = JD.descendants_mask(dag, x)
                return dag, regs, out4(m.sum(), JD.last_by_age(dag, m),
                                       JD.first_by_age(dag, m),
                                       (m & dag.vis_d).sum())
            if op in (D.OP_RELEASE_CHAIN, D.OP_RELEASE_CLOSURE):
                fn2 = (JD.release_chain if op == D.OP_RELEASE_CHAIN
                       else JD.release_closure)
                dag = fn2(dag, x, f[0])
                return dag, regs, out4(visible(dag))
            if op == D.OP_CA:
                v = JD.common_ancestor_masked(dag, x, y)
            elif op == D.OP_CHAIN_FIRST:
                v = JD.chain_first_at_most(dag, x, dag.height,
                                           hreg(dag, x) - a[1])
            elif op == D.OP_FIRST_BY_AGE:
                v = JD.first_by_age(dag, JD.children0_mask(dag, x)
                                    & (dag.kind == a[1]))
            elif op == D.OP_LAST_BY_AGE:
                v = JD.last_by_age(dag, JD.children0_mask(dag, x)
                                   & (dag.kind == a[1]))
            elif op == D.OP_BLOCK_AT_HEIGHT:
                v = JD.block_at_height(dag, x, hreg(dag, x) - a[1])
            else:
                v = JD.common_ancestor_by_height(dag, x, y)
            return dag, regs.at[a[2]].set(v), out4(v)
        return fn

    branches = [op_fn(o) for o in allowed]
    sel = np.array([list(allowed).index(int(o)) for o in ops], np.int32)

    def lane(a_all, f_all):
        dag = JD.empty(capacity, P, lift=lift, ring=ring, anc_masks=masks)
        regs = jnp.full((D.SCRIPT_REGS,), -1, i32)

        def body(c, xs):
            s, a, f = xs
            dag, regs, out = jax.lax.switch(s, branches, *c, a, f)
            return (dag, regs), out

        (dag, regs), outs = jax.lax.scan(body, (dag, regs),
                                         (jnp.asarray(sel), a_all, f_all))
        return dag, regs, outs

    dag, regs, outs = jax.jit(jax.vmap(lane, in_axes=(1, 1)))(
        jnp.asarray(args), jnp.asarray(fargs))
    return dag, regs, jnp.swapaxes(outs, 0, 1)


def assert_dag(t: D.Dag, j, what=""):
    for f in D.FIELDS:
        if f == "parents":
            for p, (a, b) in enumerate(zip(t.parents, j.parents)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{what} parents[{p}]")
        else:
            g, w = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


def run_both(mode, seed):
    capacity, ring, masks, lift, allowed = MODES[mode]
    ops, args, fargs = D.make_script(seed, L, T, P, ops=allowed, lift=lift)
    want = jax_script(capacity, ring, masks, lift, allowed, ops, args, fargs)
    dag = D.empty(L, capacity, P, lift=lift, ring=ring, anc_masks=masks)
    got = D.dag_script(dag, ops, torch.from_numpy(args),
                       torch.from_numpy(fargs))
    return ops, got, want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_script_matches_reference(mode):
    ops, (dag, regs, out), (jdag, jregs, jout) = run_both(mode, 7)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(regs.numpy(), np.asarray(jregs))
    assert_dag(dag, jdag, mode)
    if mode.startswith("ring"):
        appended = out[torch.from_numpy(ops == D.OP_APPEND)][..., 0] >= 0
        assert int(appended.sum(0).min()) > 2 * MODES[mode][0]  # wrapped
        assert bool(dag.overflow.any()) and not bool(dag.overflow.all())
        assert int(dag.live_floor.max()) > 0  # retirement moved the floor
    # every op kind ran, and the queries found blocks
    assert set(np.unique(ops)) == set(MODES[mode][4])
    assert int((out[..., 0] >= 0).sum()) > L * T // 2


def test_top_k_ties_and_short_masks():
    score = torch.tensor([[3., 1., 1., 2., 1.], [5., 5., 5., 5., 5.]])
    mask = torch.tensor([[True, True, False, True, True],
                         [False, True, False, False, False]])
    idx, valid = D.top_k_by(score, mask, 4)
    jidx, jvalid = jax.vmap(lambda s, m: JD.top_k_by(s, m, 4))(
        jnp.asarray(score.numpy()), jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # ties go to the lowest slot; past the mask, slot 0 and invalid
    assert idx.tolist() == [[1, 4, 3, 0], [1, 0, 0, 0]]
    assert valid.tolist() == [[True] * 4, [True, False, False, False]]
    for largest in (False, True):  # the sort path beyond k = 16
        s = torch.from_numpy(np.random.default_rng(0).integers(
            0, 4, (3, 40)).astype(np.float32))
        m = s != 3
        i2, v2 = D.top_k_by(s, m, 20, largest=largest)
        ji, jv = jax.vmap(lambda a, b: JD.top_k_by(a, b, 20, largest))(
            jnp.asarray(s.numpy()), jnp.asarray(m.numpy()))
        np.testing.assert_array_equal(i2.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v2.numpy(), np.asarray(jv))


def test_empty_and_modes():
    dag = D.empty(2, 8, 3, ring=True, anc_masks=True)
    j = JD.empty(8, 3, ring=True, anc_masks=True)
    for f in D.FIELDS:
        if f == "parents":
            continue
        g = getattr(dag, f)
        assert g.shape[1:] == np.asarray(getattr(j, f)).shape, f
        np.testing.assert_array_equal(g[1].numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert dag.is_ring and dag.has_masks and not dag.lifted
    with pytest.raises(ValueError, match="ring \\+ lift"):
        D.empty(1, 8, 1, ring=True, lift=True)
