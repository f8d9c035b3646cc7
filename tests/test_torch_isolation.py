"""The port stands alone: no module of `cpr_tpu_torch`, and not
`chip_smoke.py`, imports jax, flax, optax, pydantic, msgpack or cpr_tpu;
yaml only inside `train.config.TrainConfig.from_yaml`; gymnasium only
under `cpr_tpu_torch/gym/`; the package imports and trains with those
modules blocked; `cpr_tpu.train` and `cpr_tpu_torch.train` resolve to
their own packages; entry points refuse to run without a device; the
kernel wrappers refuse CPU tensors."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cpr_tpu_torch import _device, kernels
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
from cpr_tpu_torch.params import make_params

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cpr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pydantic", "msgpack",
             "cpr_tpu")
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in (tree.body if top_level_only else ast.walk(tree)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_forbidden_imports(path):
    for root in imported_roots(path):
        assert root not in FORBIDDEN, f"{path} imports {root}"
        if root == "gymnasium":
            assert path.parent == PKG / "gym", f"{path} imports gymnasium"


BLOCKED_IMPORT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "pydantic", "yaml", "msgpack",
             "gymnasium", "cpr_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import importlib
for mod in ("cpr_tpu_torch", "cpr_tpu_torch.envs", "cpr_tpu_torch.envs.nakamoto",
            "cpr_tpu_torch.kernels", "cpr_tpu_torch.convert",
            "cpr_tpu_torch.random", "cpr_tpu_torch.core.dag",
            "cpr_tpu_torch.envs.bk", "cpr_tpu_torch.envs.ethereum",
            "cpr_tpu_torch.envs.quorum", "cpr_tpu_torch.envs.tailstorm",
            "cpr_tpu_torch.envs.stree", "cpr_tpu_torch.envs.tailstorm_june",
            "cpr_tpu_torch.envs.spar", "cpr_tpu_torch.envs.sdag",
            "cpr_tpu_torch.envs.assumption", "cpr_tpu_torch.learn.buffer",
            "cpr_tpu_torch.train.ppo", "cpr_tpu_torch.train.optim",
            "cpr_tpu_torch.train.config", "cpr_tpu_torch.train.driver",
            "cpr_tpu_torch.train.serialization", "cpr_tpu_torch.netsim",
            "cpr_tpu_torch.netsim.compile", "cpr_tpu_torch.netsim.engine",
            "cpr_tpu_torch.netsim.attack", "cpr_tpu_torch.network",
            "cpr_tpu_torch.distributions", "chip_smoke"):
    importlib.import_module(mod)
from cpr_tpu_torch.train import config, driver
cfg = config.TrainConfig.from_dict(dict(
    protocol="nakamoto", alpha=dict(min=0.2, max=0.4), episode_len=8,
    n_envs=8, ppo=dict(n_steps=8, n_minibatches=2, update_epochs=1,
                       layer_size=8),
    eval=dict(freq=1, start_at_iteration=0, episodes_per_alpha=2)))
net, history, rows = driver.train_from_config(cfg, n_updates=1,
                                              device="cpu")
assert len(history) == 1 and rows
from cpr_tpu_torch import envs, random
from cpr_tpu_torch.params import make_params
env = envs.get("nakamoto")
stats = env.make_episode_stats_fn(make_params(alpha=0.35, gamma=0.5,
                                              max_steps=8),
                                  "sapirshtein-2016-sm1", 20)(
    random.split(random.PRNGKey(0, device="cpu"), 4))
assert int(stats["n_episodes"].sum()) == 8
for key in ("bk-2-constant", "ethereum-byzantium",
            "tailstorm-2-discount-heuristic", "stree-2-constant-optimal",
            "spar-2-constant", "sdag-2-discount-heuristic"):
    env = envs.get(key, window=32)
    stats = env.make_episode_stats_fn(make_params(alpha=0.35, gamma=0.5,
                                                  max_steps=6),
                                      env.scripted_policies[1], 14)(
        random.split(random.PRNGKey(0, device="cpu"), 2))
    assert int(stats["n_episodes"].sum()) == 4, key
from cpr_tpu_torch import netsim, network
net = network.symmetric_clique(4, activation_delay=30.0, propagation_delay=1.0)
for mode in ("scan", "event"):
    out = netsim.Engine(net, activations=30, mode=mode, device="cpu").run(
        [0, 1], [30.0, 30.0])
    assert out["node_act"].sum() == 60, mode
out = netsim.AttackEngine(net, activations=30, device="cpu").run(
    [0, 1], [30.0, 30.0], [0.3, 0.4], [0, 2])
assert out["n_act"].tolist() == [30, 30]
try:
    import cpr_tpu_torch.gym
except ImportError:
    pass
else:
    raise SystemExit("cpr_tpu_torch.gym imported without gymnasium")
print("isolated-ok")
"""


def test_imports_with_jax_flax_gymnasium_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated-ok" in out.stdout


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    # alone in a directory (and, here, without a CUDA device) it must fail
    # and print no result line
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rnd.PRNGKey(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rnd.from_numpy_words(np.zeros((1, 2), np.uint32))
    assert rnd.PRNGKey(0, device="cpu").device.type == "cpu"
    # the bk and Ethereum entry points: the gym surface and the state
    # conversion resolve their device the same way
    from cpr_tpu_torch import convert
    from cpr_tpu_torch.envs.bk import BkSSZ
    from cpr_tpu_torch.envs.ethereum import EthereumSSZ
    from cpr_tpu_torch.envs.stree import StreeSSZ
    from cpr_tpu_torch.envs.tailstorm import TailstormSSZ
    gym = pytest.importorskip("cpr_tpu_torch.gym")
    for key in ("bk-8-constant", "ethereum-byzantium",
                "tailstorm-8-discount-heuristic",
                "stree-8-constant-heuristic"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gym.Core(key, max_steps=8, window=128)
    for env in (BkSSZ(k=2, window=32), EthereumSSZ(window=32),
                TailstormSSZ(k=2, window=32), StreeSSZ(k=2)):
        params = make_params(alpha=0.35, gamma=0.5, max_steps=8)
        state = env.init_lanes(rnd.split(rnd.PRNGKey(0, device="cpu"), 2),
                               params)[0]
        d = convert.dag_state_to_numpy(state)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.dag_state_from_numpy(env, d)
        assert convert.dag_state_from_numpy(env, d, device="cpu") \
            .dag.gid.device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    env = NakamotoSSZ()
    params = make_params(alpha=0.35, gamma=0.5, max_steps=8)
    keys = rnd.split(rnd.PRNGKey(0, device="cpu"), 4)
    state, obs = env.reset_lanes(keys, params)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.threefry(keys, 2, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stream(state, obs, keys, 1, 4, params, 3, True, True)
    mask = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.step_lanes(state, obs, torch.zeros(4, dtype=torch.int32),
                           mask, state, obs, mask, params, True, True)
    from cpr_tpu_torch.core import dag as D
    from cpr_tpu_torch.envs import quorum as Q
    from cpr_tpu_torch.envs.bk import BkSSZ
    from cpr_tpu_torch.envs.ethereum import EthereumSSZ
    from cpr_tpu_torch.envs.sdag import SdagSSZ
    from cpr_tpu_torch.envs.spar import SparSSZ
    from cpr_tpu_torch.envs.stree import StreeSSZ
    from cpr_tpu_torch.envs.tailstorm import TailstormSSZ
    for denv in (BkSSZ(k=2, window=32), EthereumSSZ(window=32),
                 TailstormSSZ(k=2, window=32), StreeSSZ(k=2, window=32),
                 SparSSZ(k=2, window=32), SdagSSZ(k=2, window=32)):
        dstate, dobs = denv.init_lanes(keys, params)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.dag_stream(denv, dstate, dobs, keys, 1, 4, params, 0)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.dag_step_lanes(denv, dstate, dobs,
                                   torch.zeros(4, dtype=torch.int32), mask,
                                   dstate, dobs, mask, params)
        if isinstance(denv, (TailstormSSZ, StreeSSZ)):  # K9's check too
            with pytest.raises(ValueError, match="CUDA"):
                kernels.quorum_check(dstate.dag,
                                     Q.check_inputs(denv, dstate),
                                     Q.check_cfg(denv))
    ops, args, fargs = D.make_script(0, 4, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dag_script(D.empty(4, 16, 3, ring=True, anc_masks=True), ops,
                           torch.from_numpy(args), torch.from_numpy(fargs))
    assert kernels.launches == before


def test_tailstorm_gym_ids_resolve_to_their_packages():
    """In one process that imports both packages, the port's id resolves
    to the port and the reference's to the reference, with the same
    protocol arguments."""
    gymnasium = pytest.importorskip("gymnasium")
    import cpr_tpu.gym  # noqa: F401
    import cpr_tpu_torch.gym  # noqa: F401
    t = gymnasium.spec("cpr-tailstorm-torch-v0")
    j = gymnasium.spec("cpr-tailstorm-v0")
    assert t.entry_point.__module__.startswith("cpr_tpu_torch.")
    assert j.entry_point.__module__.startswith("cpr_tpu.")
    assert t.kwargs == j.kwargs


def test_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setenv("CPR_TORCH_BUILD_DIR", str(tmp_path))
    paths = kernels.library_paths()
    assert set(paths) == set(kernels.SOURCES)
    tags = {p.name.rsplit("-", 1)[1] for p in paths.values()}
    assert len(tags) == 1 and all(p.parent == tmp_path
                                  for p in paths.values())
    for p in paths.values():  # present libraries are not rebuilt
        p.write_bytes(b"")
    assert kernels.build() == paths


BLOCKED_MDP_IMPORT = """
import sys
for name in ("jax", "jaxlib", "flax", "gymnasium", "cpr_tpu"):
    sys.modules[name] = None
import importlib
for mod in ("cpr_tpu_torch.telemetry", "cpr_tpu_torch.native",
            "cpr_tpu_torch.mdp", "cpr_tpu_torch.mdp.explicit",
            "cpr_tpu_torch.mdp.compiler", "cpr_tpu_torch.mdp.implicit",
            "cpr_tpu_torch.mdp.models", "cpr_tpu_torch.mdp.generic",
            "cpr_tpu_torch.mdp.generic.native", "cpr_tpu_torch.experiments",
            "cpr_tpu_torch.experiments.measure_mdp",
            "cpr_tpu_torch.integrity", "cpr_tpu_torch.resilience",
            "cpr_tpu_torch.mdp.frontier", "cpr_tpu_torch.mdp.grid",
            "cpr_tpu_torch.mdp.rtdp", "cpr_tpu_torch.mdp.rtdp_graph",
            "cpr_tpu_torch.mdp.explorer", "cpr_tpu_torch.parallel",
            "cpr_tpu_torch.parallel.grid",
            "cpr_tpu_torch.experiments.break_even",
            "cpr_tpu_torch.experiments.measure_rtdp"):
    importlib.import_module(mod)
from cpr_tpu_torch.mdp import Compiler, ptmdp
from cpr_tpu_torch.mdp.models import Fc16BitcoinSM
tm = ptmdp(Compiler(Fc16BitcoinSM(alpha=0.3, gamma=0.5,
                                  maximum_fork_length=4)).mdp(),
           horizon=10).tensor(device="cpu")
vi = tm.value_iteration(stop_delta=1e-5)
assert vi["vi_iter"] > 0 and (vi["vi_policy"] >= -1).all()
print("mdp-isolated-ok")
"""


def test_mdp_modules_import_with_jax_and_cpr_tpu_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", BLOCKED_MDP_IMPORT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mdp-isolated-ok" in out.stdout


def _tiny_mdp():
    from cpr_tpu_torch.mdp import Compiler
    from cpr_tpu_torch.mdp.models import Fc16BitcoinSM
    return Compiler(Fc16BitcoinSM(alpha=0.3, gamma=0.5,
                                  maximum_fork_length=3)).mdp()


def test_mdp_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from cpr_tpu_torch import convert
    from cpr_tpu_torch.experiments import measure_rows, model_battery
    mdp = _tiny_mdp()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mdp.tensor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_rows(model_battery(alphas=(0.3,), generic_cutoff=3, mfl=3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.tensor_mdp(mdp.n_states, mdp.n_actions,
                           np.ones(mdp.n_states), *mdp.arrays())
    assert mdp.tensor(device="cpu").prob.device.type == "cpu"


def test_mdp_kernel_wrappers_refuse_cpu_tensors():
    from cpr_tpu_torch.mdp.explicit import _Ctl
    tm = _tiny_mdp().tensor(device="cpu")
    S = tm.n_states
    c = _Ctl(torch.float32, torch.device("cpu"), 4)
    v = [torch.zeros(S), torch.zeros(S)]
    pol = torch.zeros(S, dtype=torch.int32)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.vi_sweeps(tm, 1.0, v, v, pol, c.ctl, c.delta, c.resid, 4, 0,
                          1, stop_delta=0.0, max_iter=1, can_stop=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pe_sweeps(tm, pol, 1.0, v, v, c.ctl, c.delta, 0, 1,
                          theta=0.0, max_iter=1)
    assert kernels.launches == before


BLOCKED_GRID_RUN = """
import sys
for name in ("jax", "jaxlib", "flax", "gymnasium", "cpr_tpu"):
    sys.modules[name] = None
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.mdp import grid, rtdp_graph
pm = grid.param_ptmdp(grid.compile_protocol("fc16", cutoff=3, n_workers=2),
                      horizon=10)
vi = grid.grid_value_iteration(pm, (0.3,), (0.5,), stop_delta=1e-5,
                               device="cpu")
assert vi["grid_converged"].all()
r = rtdp_graph(pm.mdp.tensor(device="cpu"), rnd.PRNGKey(0, device="cpu"),
               max_steps=5, batch=4, buffer=8)
assert r["rtdp_steps"] == 5
print("grid-isolated-ok")
"""


def test_grid_and_rtdp_run_with_jax_and_cpr_tpu_blocked():
    # frontier workers are spawned processes: they import the port only
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", BLOCKED_GRID_RUN],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "grid-isolated-ok" in out.stdout


def test_grid_and_rtdp_entry_points_need_a_device(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from cpr_tpu_torch.experiments import measure_rows_grid
    from cpr_tpu_torch.experiments.break_even import exact_revenue_curve
    from cpr_tpu_torch.experiments.measure_rtdp import measure_rtdp_rows
    from cpr_tpu_torch.mdp import grid

    monkeypatch.setenv("CPR_MDP_CACHE", str(tmp_path))
    pm = grid.compile_protocol("fc16", cutoff=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.grid_value_iteration(pm, (0.3,), (0.5,), stop_delta=1e-5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.solve_grid_cached("fc16", cutoff=3, alphas=(0.3,),
                               gammas=(0.5,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exact_revenue_curve("fc16", gamma=0.5, cutoff=3, alphas=(0.3,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_rows_grid([("fc16", 3, {}, "fc16")], alphas=(0.3,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_rtdp_rows([("fc16", lambda: None)])
    assert os.listdir(tmp_path) == []


def test_grid_and_rtdp_kernel_wrappers_refuse_cpu_tensors():
    from cpr_tpu_torch.mdp import explicit as E
    tm = _tiny_mdp().tensor(device="cpu")
    S = tm.n_states
    probs = tm.prob[None].clone()
    valid = E.grid_valid_segments(tm, probs)
    planes = [torch.zeros((1, S)), torch.zeros((1, S))]
    pol = torch.zeros((1, S), dtype=torch.int32)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grid_vi_sweeps(tm, probs, valid,
                               torch.zeros(1, dtype=torch.int32), 1.0,
                               planes, planes, pol,
                               torch.zeros((1, 1), dtype=torch.int64), 1)
    v = torch.zeros(S)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rtdp_walkers(tm, torch.zeros(2, dtype=torch.int32), v, v,
                             E.start_cdf(tm), graph=True, max_steps=1,
                             batch=1, cap=1, eps=0.5, restart_p=0.5,
                             discount=1.0, stop_delta=0.0, decay=0.5)
    assert kernels.launches == before


TRAIN_FILES = sorted((PKG / "train").glob("*.py")) + sorted(
    (PKG / "learn").glob("*.py")) + [PKG / "envs" / "assumption.py"]


@pytest.mark.parametrize("path", TRAIN_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in TRAIN_FILES])
def test_train_modules_import_no_yaml_at_import_time(path):
    """yaml may be imported where `from_yaml` runs, never when a module
    is imported (the card's machine has none)."""
    assert "yaml" not in set(imported_roots(path, top_level_only=True))
    nested = set(imported_roots(path)) - set(
        imported_roots(path, top_level_only=True))
    assert "yaml" not in nested or path.name == "config.py", path


def test_train_packages_resolve_to_their_own():
    """In one process that imports both, each package's train modules
    are its own: the reference's ActorCritic is flax's, the port's
    torch's, and neither reaches into the other."""
    import inspect

    import cpr_tpu.train.ppo as jppo
    import cpr_tpu_torch.train.ppo as tppo
    import cpr_tpu_torch.train.driver as tdriver
    def where(cls):
        return Path(inspect.getfile(cls)).resolve()

    assert where(tppo.ActorCritic).is_relative_to(PKG)
    assert not where(jppo.ActorCritic).is_relative_to(PKG)
    assert issubclass(tppo.ActorCritic, torch.nn.Module)
    assert not issubclass(jppo.ActorCritic, torch.nn.Module)
    assert tdriver.ActorCritic is tppo.ActorCritic
    for mod in (tppo, tdriver):
        for name, obj in vars(mod).items():
            origin = getattr(obj, "__module__", None) or ""
            assert not origin.startswith("cpr_tpu.") and origin != "cpr_tpu", \
                (mod.__name__, name, origin)


def test_k11_wrappers_refuse_cpu_tensors():
    from cpr_tpu_torch.train.ppo import ActorCritic
    net = ActorCritic(4, 4, (8, 8), device="cpu")
    before = dict(kernels.launches)
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.actor_check(net, torch.zeros((4, 4)), warp=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gae(x[None], x[None], x[None].bool(), x, 0.99, 0.95)
    loss_in = (torch.zeros((4, 2)), x, x.int(), x, x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ppo_loss_fwd(*loss_in, 0.2, 0.5, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ppo_loss_bwd(*loss_in, torch.zeros(2), torch.ones(()), 0.2,
                             0.5, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.adam(x, x, x, x, neg_lr=-1e-3, bc1=0.1, bc2=0.001, b1=0.9,
                     b2=0.999, omb1=0.1, omb2=0.001, eps=1e-5, max_norm=0.5)
    assert kernels.launches == before


def test_chip_smoke_constants_are_assigned_once():
    """Each module-level name of chip_smoke.py is bound once: a second
    binding silently resizes the phases that read the first (the
    net-policy streams' 512 lanes read the netsim path's 96)."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    seen = {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        seen.setdefault(n.id, []).append(node.lineno)
    twice = {k: v for k, v in seen.items() if len(v) > 1}
    assert not twice, f"bound more than once: {twice}"


def test_chip_smoke_main_binds_each_name_once():
    """Each name chip_smoke.py's main() assigns is assigned once: the
    fixtures are loaded into dicts side by side, and a second binding of
    one name (the netsim protocols' fixture over the PPO fixture's) hands
    the later phases the wrong fixture."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    seen = {}
    for node in ast.walk(main):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and isinstance(n.ctx,
                                                              ast.Store):
                        seen.setdefault(n.id, []).append(node.lineno)
    twice = {k: v for k, v in seen.items() if len(v) > 1}
    assert not twice, f"main() binds more than once: {twice}"
