"""Build, load and launch the port's CUDA kernels.

Each source under `cpr_tpu_torch/csrc/` (`*.cu`) is compiled by `nvcc`
for sm_90a into its own shared library with a plain C interface, at
first use, into `build/cpr_tpu_torch/` beside the package (or
`$CPR_TORCH_BUILD_DIR`). The file name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
All sources compile in parallel, one `nvcc` each. The libraries are
loaded with ctypes; every pointer and the stream pass as `c_void_p`, and
each C entry point returns the launch's `cudaError_t`, which the wrapper
turns into an exception.

The wrappers here launch only: they take CUDA tensors, check device,
dtype, shape, contiguity and alignment, allocate the outputs with
`torch.empty`, launch on PyTorch's current stream without synchronising,
and add one to `launches[<kernel>]` per launch. Dispatch between a
kernel and its plain twin happens in the calling modules, on the device
of the tensor: a CUDA tensor never reaches a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("random.cu", "nakamoto_stream.cu", "mdp_sweep.cu", "rtdp.cu",
           "dag_script.cu", "bk_stream.cu", "ethereum_stream.cu",
           "quorum_check.cu", "tailstorm_stream.cu", "stree_stream.cu",
           "spar_stream.cu", "sdag_stream.cu", "actor_check.cu", "gae.cu",
           "ppo_loss.cu", "adam.cu",
           "netsim_scan.cu", "netsim_event.cu", "netsim_attack.cu",
           "netsim_event_bk.cu", "netsim_event_eth.cu", "netsim_event_spar.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last reset_launches(). K8 and K9 are sets
# of device functions (csrc/dag.cuh, csrc/quorum.cuh) that K10 runs inside
# its own launches; their counts are those of their check kernels
# (csrc/dag_script.cu, csrc/quorum_check.cu). K11-act (csrc/actor.cuh) runs
# inside K2 and K10 too: a stream launch with the net adds one to it as
# well as to its own kernel, and so does its check kernel
# (csrc/actor_check.cu). K11-loss counts its forward and backward launches.
# K12-event-bk/-eth/-spar count the protocol kernels of the event engine
# (csrc/netsim_event_{bk,eth,spar}.cu).
launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0,
            "K8": 0, "K9": 0, "K10-bk": 0, "K10-eth": 0, "K10-ts": 0,
            "K10-stree": 0, "K10-spar": 0, "K10-sdag": 0, "K11-act": 0,
            "K11-gae": 0, "K11-loss": 0,
            "K11-adam": 0, "K12-scan": 0, "K12-event": 0, "K13": 0,
            "K12-event-bk": 0, "K12-event-eth": 0, "K12-event-spar": 0}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_p = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build_dir() -> Path:
    env = os.environ.get("CPR_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "cpr_tpu_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_paths() -> dict[str, Path]:
    d, tag = build_dir(), _digest()
    return {src: d / f"lib{Path(src).stem}-{tag}.so" for src in SOURCES}


def build() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; the
    compiler's `-Xptxas -v` report goes beside each library as `.log`.
    Returns {source: library path}."""
    paths = library_paths()
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    next(iter(todo.values())).parent.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for src, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(src)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[src])
    if failed:
        logs = "\n".join(todo[s].with_suffix(".log").read_text()[-4000:]
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


class _StatePtrs(ctypes.Structure):
    _fields_ = [(f, _p) for f in (
        "a", "h", "event", "match_h", "ca_atk", "ca_def", "ca_progress",
        "time", "t_priv", "t_pub", "steps", "n_activations",
        "last_reward_attacker", "last_reward_defender", "last_progress",
        "last_chain_time", "last_sim_time", "key")]


_PARAM_FIELDS = ("alpha", "gamma", "activation_delay", "max_progress",
                 "max_time", "max_steps")


class _ParamPtrs(ctypes.Structure):  # csrc/lane_params.cuh
    _fields_ = [(f, _p) for f in _PARAM_FIELDS]


class _NetArgs(ctypes.Structure):  # csrc/actor.cuh
    _fields_ = [(f, _p) for f in ("w", "logp", "value", "key_in",
                                  "key_out")] + [
        (f, ctypes.c_int32) for f in ("in_", "hidden", "n_actions", "mode")]


class _TrajPtrs(ctypes.Structure):
    _fields_ = [(f, _p) for f in ("obs", "action", "reward", "done", "info")]


class _SweepTable(ctypes.Structure):
    _fields_ = [*((f, _p) for f in (
        "state_seg", "seg_ptr", "seg_act", "seg_valid", "dst", "prob",
        "reward", "progress")),
        ("n_states", _i64), ("n_actions", ctypes.c_int32),
        ("f64", ctypes.c_int32)]


class _RtdpArgs(ctypes.Structure):
    _fields_ = [("V", _p), ("P", _p), ("visits", _p),
                ("buf_s", _p * 2), ("buf_pri", _p * 2), ("walkers", _p),
                ("cdf", _p), ("t_out", _p), ("resid_out", _p),
                ("max_steps", _i64), ("key0", ctypes.c_uint32),
                ("key1", ctypes.c_uint32), ("batch", ctypes.c_int32),
                ("cap", ctypes.c_int32), ("graph", ctypes.c_int32),
                ("pad", ctypes.c_int32)] + [
        (f, ctypes.c_float) for f in ("eps", "restart_p", "discount",
                                      "stop_delta", "decay")]


class _LoopCtl(ctypes.Structure):
    _fields_ = [("ctl", _p), ("delta", _p), ("resid", _p),
                ("resid_len", ctypes.c_int32), ("can_stop", ctypes.c_int32),
                ("stop_delta", ctypes.c_double), ("max_iter", _i64)]


_MAX_WINDOW = 128  # csrc/dag.cuh kNS = 4 slots per thread of a warp
_MAX_PARENTS = 17  # csrc/dag.cuh kDagMaxParents
_DAG_PLANES = ("auxf", "auxg", "aux2", "gid", "live_floor", "chain",
               "closure", "kind", "height", "aux", "pow_hash", "signer",
               "miner", "vis_a", "vis_d", "vis_d_since", "born_at",
               "cum_atk", "cum_def", "cum_prog", "n", "overflow")


class _DagPtrs(ctypes.Structure):
    _fields_ = [("parents", _p * _MAX_PARENTS)] + [
        (f, _p) for f in _DAG_PLANES] + [("W", ctypes.c_int32),
                                         ("P", ctypes.c_int32)]


class _EnvPtrs(ctypes.Structure):
    _fields_ = [("i", _p * 7), ("f", _p * 6), ("b", _p * 2), ("key", _p),
                ("stale", _p)]


class _EnvConfig(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int32) for f in (
        "k", "constant", "ctk", "max_uncles", "pref_work", "prog_work",
        "whitepaper", "strict", "scheme", "selection", "cmax", "rscan",
        "opt_window", "unit")]


_MAX_FRAME = 64  # csrc/quorum.cuh kQMaxC: one 64-bit mask of candidates
_CHECK_CFG = ("env", "C", "q", "k", "width", "window", "discount", "punish",
              "depth_plus", "miner_share", "R")


class _CheckIn(ctypes.Structure):
    _fields_ = [(f, _p) for f in ("cand", "own", "seen", "score", "stale",
                                  "pub", "priv")]


class _CheckCfg(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int32) for f in _CHECK_CFG]


class _CheckOut(ctypes.Structure):
    _fields_ = [(f, _p) for f in ("cidx", "cvalid", "abits", "found",
                                  "leaves", "row", "ovr", "mat", "rfound",
                                  "head", "stale")]


class _NetPlanes(ctypes.Structure):  # csrc/netsim.cuh Planes
    _fields_ = [(f, _p) for f in ("kind", "p0", "p1", "logw")] + [
        ("n", ctypes.c_int32)]


_NET_OUT = ("head", "head_height", "sim_time", "n_blocks", "n_act",
            "node_act", "reward", "steps", "drop_q", "drop_p", "drop_b",
            "win_miss", "exhausted")


class _NetOut(ctypes.Structure):  # csrc/netsim.cuh Out
    _fields_ = [(f, _p) for f in _NET_OUT]


class _Ledger(ctypes.Structure):  # csrc/netsim_event.cuh Ledger
    _fields_ = [(f, _p) for f in ("parent", "height", "miner", "vis",
                                  "known", "wq")] + [
        (f, ctypes.c_int32) for f in ("B", "M", "F", "S", "A", "WA")]


_PROTO_PLANES = ("is_vote", "nvotes", "powh", "lhash", "conf", "conf_own",
                 "mybest", "repl", "noprop", "quorum", "work", "uncles",
                 "progress", "on_chain")


class _Proto(ctypes.Structure):  # csrc/netsim_event.cuh Proto
    _fields_ = [(f, _p) for f in _PROTO_PLANES] + [
        (f, ctypes.c_int32) for f in ("k", "qw", "W", "U", "byz",
                                      "block_scheme")]


class _LaneIn(ctypes.Structure):  # csrc/netsim_event.cuh LaneIn
    _fields_ = [(f, _p) for f in ("keys", "delays", "policy")] + [
        ("n_lanes", _i64), ("strict_match", ctypes.c_int32)]


def _load() -> dict[str, ctypes.CDLL]:
    with _lock:
        if _libs:
            return _libs
        paths = build()
        rnd = ctypes.CDLL(str(paths["random.cu"]))
        rnd.cpr_k1_threefry.argtypes = [_p, _i64, _i64, ctypes.c_uint32,
                                        _int, _p, _p]
        rnd.cpr_k1_threefry.restype = _int
        rnd.cpr_k1_error_string.argtypes = [_int]
        rnd.cpr_k1_error_string.restype = ctypes.c_char_p
        nak = ctypes.CDLL(str(paths["nakamoto_stream.cu"]))
        sp, pp = ctypes.POINTER(_StatePtrs), ctypes.POINTER(_ParamPtrs)
        npp = ctypes.POINTER(_NetArgs)
        nak.cpr_k2_stream.argtypes = [sp, _p, _p, _int, _i64, _int, pp, _int,
                                      _int, _int, _int, _p, _p,
                                      ctypes.POINTER(_TrajPtrs), npp, _p]
        nak.cpr_k2_stream.restype = _int
        nak.cpr_k3_step_lanes.argtypes = [sp, _p, _p, _p, sp, _p, _p, _i64,
                                          pp, _int, _int, _int, _p, _p, _p,
                                          _p, _p]
        nak.cpr_k3_step_lanes.restype = _int
        nak.cpr_k23_error_string.argtypes = [_int]
        nak.cpr_k23_error_string.restype = ctypes.c_char_p
        mdp = ctypes.CDLL(str(paths["mdp_sweep.cu"]))
        tp, cp = ctypes.POINTER(_SweepTable), ctypes.POINTER(_LoopCtl)
        mdp.cpr_k4_vi_sweeps.argtypes = [tp, cp, ctypes.c_double, _p, _p, _p,
                                         _p, _p, _i64, _int, _p]
        mdp.cpr_k4_vi_sweeps.restype = _int
        mdp.cpr_k5_pe_sweeps.argtypes = [tp, cp, _p, ctypes.c_double, _p, _p,
                                         _p, _p, _i64, _int, _p]
        mdp.cpr_k5_pe_sweeps.restype = _int
        mdp.cpr_k7_grid_sweeps.argtypes = [tp, _p, _p, _p, _int, _i64, _i64,
                                           ctypes.c_double, _p, _p, _p, _p,
                                           _p, _p, _int, _p]
        mdp.cpr_k7_grid_sweeps.restype = _int
        mdp.cpr_k45_error_string.argtypes = [_int]
        mdp.cpr_k45_error_string.restype = ctypes.c_char_p
        rt = ctypes.CDLL(str(paths["rtdp.cu"]))
        rt.cpr_k6_rtdp.argtypes = [tp, ctypes.POINTER(_RtdpArgs), _int, _int,
                                   _p]
        rt.cpr_k6_rtdp.restype = _int
        rt.cpr_k6_error_string.argtypes = [_int]
        rt.cpr_k6_error_string.restype = ctypes.c_char_p
        dp, ep = ctypes.POINTER(_DagPtrs), ctypes.POINTER(_EnvPtrs)
        cfg = ctypes.POINTER(_EnvConfig)
        k8 = ctypes.CDLL(str(paths["dag_script.cu"]))
        k8.cpr_k8_dag_script.argtypes = [dp, _p, _int, _p, _int, _p, _i64, _p,
                                         _p, _p]
        k8.cpr_k8_dag_script.restype = _int
        k8.cpr_k8_error_string.argtypes = [_int]
        k8.cpr_k8_error_string.restype = ctypes.c_char_p
        k9 = ctypes.CDLL(str(paths["quorum_check.cu"]))
        k9.cpr_k9_quorum_check.argtypes = [
            dp, ctypes.POINTER(_CheckIn), ctypes.POINTER(_CheckCfg), _i64,
            ctypes.POINTER(_CheckOut), _p]
        k9.cpr_k9_quorum_check.restype = _int
        k9.cpr_k9_error_string.argtypes = [_int]
        k9.cpr_k9_error_string.restype = ctypes.c_char_p
        _libs.update(random=rnd, nakamoto=nak, mdp=mdp, rtdp=rt, dag=k8,
                     quorum=k9)
        for name, src in (("bk", "bk_stream.cu"),
                          ("eth", "ethereum_stream.cu"),
                          ("ts", "tailstorm_stream.cu"),
                          ("stree", "stree_stream.cu"),
                          ("spar", "spar_stream.cu"),
                          ("sdag", "sdag_stream.cu")):
            lib = ctypes.CDLL(str(paths[src]))
            stream_fn = getattr(lib, f"cpr_k10_{name}_stream")
            stream_fn.argtypes = [dp, ep, _p, _p, _int, _i64, _int, pp, cfg,
                                  _int, _int, _p, _p, _p, npp, _p]
            stream_fn.restype = _int
            lanes_fn = getattr(lib, f"cpr_k10_{name}_step_lanes")
            lanes_fn.argtypes = [dp, ep, _p, _p, _p, dp, ep, _p, _p, _i64, pp,
                                 cfg, _int, _p, _p, _p, _p, _p]
            lanes_fn.restype = _int
            err = f"cpr_k10_{name}_error_string"
            getattr(lib, err).argtypes = [_int]
            getattr(lib, err).restype = ctypes.c_char_p
            _libs[f"k10_{name}"] = lib
        act = ctypes.CDLL(str(paths["actor_check.cu"]))
        act.cpr_k11_actor_check.argtypes = [npp, _p, _int, _p, _p, _i64,
                                            _int, _p, _p]
        gae_lib = ctypes.CDLL(str(paths["gae.cu"]))
        gae_lib.cpr_k11_gae.argtypes = [_p, _p, _p, _p, _int, _i64,
                                        ctypes.c_float, ctypes.c_float, _p,
                                        _p, _p]
        loss = ctypes.CDLL(str(paths["ppo_loss.cu"]))
        f3 = [ctypes.c_float] * 3
        loss.cpr_k11_loss_fwd.argtypes = [_p, _i64, _int, *f3, _p, _p, _p]
        loss.cpr_k11_loss_bwd.argtypes = [_p, _i64, _int, *f3, _p, _p, _p,
                                          _p, _p]
        adam_lib = ctypes.CDLL(str(paths["adam.cu"]))
        adam_lib.cpr_k11_adam.argtypes = [_p, _p, _p, _p, _i64,
                                          *[ctypes.c_float] * 9, _p, _p]
        for lib, fns, err in (
                (act, ("cpr_k11_actor_check",), "cpr_k11_act_error_string"),
                (gae_lib, ("cpr_k11_gae",), "cpr_k11_gae_error_string"),
                (loss, ("cpr_k11_loss_fwd", "cpr_k11_loss_bwd"),
                 "cpr_k11_loss_error_string"),
                (adam_lib, ("cpr_k11_adam",), "cpr_k11_adam_error_string")):
            for fn in fns:
                getattr(lib, fn).restype = _int
            getattr(lib, err).argtypes = [_int]
            getattr(lib, err).restype = ctypes.c_char_p
        _libs.update(actor=act, gae=gae_lib, loss=loss, adam=adam_lib)
        plp, outp = ctypes.POINTER(_NetPlanes), ctypes.POINTER(_NetOut)
        scan = ctypes.CDLL(str(paths["netsim_scan.cu"]))
        scan.cpr_k12_scan.argtypes = [_p, _p, _p, _p, _i64, _int, _int, _int,
                                      ctypes.c_double, plp, outp, _p]
        ev_args = [ctypes.POINTER(_LaneIn), ctypes.POINTER(_Ledger), plp,
                   _int, outp, _p]
        event = ctypes.CDLL(str(paths["netsim_event.cu"]))
        event.cpr_k12_event.argtypes = ev_args
        attack = ctypes.CDLL(str(paths["netsim_attack.cu"]))
        attack.cpr_k13_attack.argtypes = ev_args
        for lib, fn, err in ((scan, "cpr_k12_scan", "cpr_k12_scan_error_string"),
                             (event, "cpr_k12_event",
                              "cpr_k12_event_error_string"),
                             (attack, "cpr_k13_attack", "cpr_k13_error_string")):
            getattr(lib, fn).restype = _int
            getattr(lib, err).argtypes = [_int]
            getattr(lib, err).restype = ctypes.c_char_p
        _libs.update(netsim_scan=scan, netsim_event=event,
                     netsim_attack=attack)
        for name in PROTOCOL_KERNELS.values():
            lib = ctypes.CDLL(str(paths[f"netsim_event_{name}.cu"]))
            fn = getattr(lib, f"cpr_k12_event_{name}")
            fn.argtypes = ev_args[:4] + [ctypes.POINTER(_Proto)] + ev_args[4:]
            fn.restype = _int
            err = getattr(lib, f"cpr_k12_event_{name}_error_string")
            err.argtypes = [_int]
            err.restype = ctypes.c_char_p
            _libs[f"netsim_event_{name}"] = lib
        return _libs


def _check(rc: int, lib, errfn: str, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, errfn)(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def _want(t: torch.Tensor, name: str, dtype, shape, device, align=4):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- K1 -----------------------------------------------------------------------

def threefry(keys: torch.Tensor, n: int, offset: int, mode: int):
    """K1: for each key in `keys` [B, 2] (int32 words, CUDA) and j < n,
    threefry2x32(key, (0, offset + j)); mode 0 returns keys [B, n, 2]
    int32, mode 1 bits [B, n] int32, modes 2/3 uniform/exponential
    [B, n] float32, modes 4/5 uniform/exponential [B, n] float64."""
    if not keys.is_cuda:
        raise ValueError("K1 takes CUDA tensors")
    dev = keys.device
    _want(keys, "keys", torch.int32, (keys.shape[0], 2), dev, align=8)
    shape = (keys.shape[0], n, 2) if mode == 0 else (keys.shape[0], n)
    dtype = (torch.int32 if mode in (0, 1) else
             torch.float64 if mode in (4, 5) else torch.float32)
    out = torch.empty(shape, dtype=dtype, device=dev)
    lib = _load()["random"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k1_threefry(keys.data_ptr(), keys.shape[0], n,
                                 offset & 0xFFFFFFFF, mode, out.data_ptr(),
                                 _stream(dev))
    _check(rc, lib, "cpr_k1_error_string", "K1 threefry")
    launches["K1"] += 1
    return out


# -- K2 / K3 ------------------------------------------------------------------

def _state_ptrs(state, n, dev, name) -> _StatePtrs:
    from cpr_tpu_torch.envs.nakamoto import INT_FIELDS, STATE_FIELDS
    ptrs = _StatePtrs()
    for f in STATE_FIELDS:
        t = getattr(state, f)
        if f == "key":
            _want(t, f"{name}.key", torch.int32, (n, 2), dev, align=8)
        else:
            dt = torch.int32 if f in INT_FIELDS else torch.float32
            _want(t, f"{name}.{f}", dt, (n,), dev)
        setattr(ptrs, f, t.data_ptr())
    return ptrs


def _params(params, n: int, dev):
    """The per-lane params arrays of `n` lanes on `dev`: a scalar field
    broadcast to [n] on the device (a host scalar is filled in, with no
    copy from the host), a stacked one taken as it is ([n]). Returns the
    struct of their pointers and the arrays, which the caller keeps
    alive until the launch is queued."""
    arrays = []
    for f in _PARAM_FIELDS:
        t = getattr(params, f)
        if t.dim() not in (0, 1) or (t.dim() == 1 and t.shape[0] != n):
            raise ValueError(f"params.{f}: shape {tuple(t.shape)}, "
                             f"expected () or ({n},)")
        dt = torch.int32 if f == "max_steps" else torch.float32
        if t.dim() == 0 and t.device.type == "cpu":
            arrays.append(torch.full((n,), t.to(dt).item(), dtype=dt,
                                     device=dev))
        else:
            arrays.append(torch.broadcast_to(t.to(dev, dt), (n,))
                          .contiguous())
    return _ParamPtrs(*(a.data_ptr() for a in arrays)), arrays


def _net_args(net, n: int, length: int, width: int, dev, max_actions: int,
              store: bool):
    """The K11-act arguments of a stream launch with the `train.ppo.
    NetPolicy` `net` over `n` lanes of input `width`: (struct, logp,
    value, key_out); logp/value [length, n] where `store`, key_out [2]
    in sample mode."""
    ac = net.net
    flat = ac.flat.detach()
    _want(flat, "net.flat", torch.float32, (ac.n_params,), dev, align=16)
    hidden = ac.hidden
    if (len(hidden) != 2 or hidden[0] != hidden[1]
            or not 0 < hidden[0] <= 96 or ac.obs_dim != width
            or not 0 < width <= 16 or not 0 < ac.n_actions <= max_actions):
        raise NotImplementedError(
            f"K11-act runs two equal hidden layers of at most 96 units on "
            f"inputs of at most 16 and at most {max_actions} actions; this "
            f"net has hidden {hidden}, input {ac.obs_dim} (the env gives "
            f"{width}) and {ac.n_actions} actions")
    sample = not net.greedy
    logp = value = key_out = key_in = None
    if store:
        f32 = dict(dtype=torch.float32, device=dev)
        logp = torch.empty((length, n), **f32)
        value = torch.empty((length, n), **f32)
    if sample:
        key_in = net.key.reshape(2).contiguous()
        _want(key_in, "net.key", torch.int32, (2,), dev, align=8)
        key_out = torch.empty((2,), dtype=torch.int32, device=dev)
    args = _NetArgs(flat.data_ptr(),
                    None if logp is None else logp.data_ptr(),
                    None if value is None else value.data_ptr(),
                    None if key_in is None else key_in.data_ptr(),
                    None if key_out is None else key_out.data_ptr(),
                    width, hidden[0], ac.n_actions, 2 if sample else 1)
    return args, logp, value, key_out, (flat, key_in)


def stream(state, obs, keys, init_mode: int, length: int, params,
           policy_id: int, strict_match: bool, unit_obs: bool,
           with_sums: bool = True, store_traj: bool = False, net=None,
           extend_obs: bool = False):
    """K2: run `length` auto-resetting steps of every lane under the
    scripted policy `policy_id` or, given `net` (a `train.ppo.NetPolicy`),
    under the actor-critic (K11-act), updating the carry (`state`, `obs`
    [L, F]) IN PLACE; F = 4, or 6 with `extend_obs` (each lane's alpha
    and gamma appended). `params` scalar or per lane [L]. init_mode 1/2
    first (re)initialises each lane from `keys` [L, 2] (stream prologue /
    raw reset); 0 continues the carry.

    Returns (sums [7, L] float32, n_done [L] int32, traj) — sums/n_done
    None unless `with_sums`, traj None unless `store_traj`, else
    (obs [T, L, F], action [T, L], reward [T, L], done [T, L],
    info [12, T, L]), followed with a net by logp [T, L], value [T, L]
    and the carry key after the launch (None when greedy)."""
    dev = obs.device
    if dev.type != "cuda":
        raise ValueError("K2 takes CUDA tensors")
    n = obs.shape[0]
    F = 6 if extend_obs else 4
    sp = _state_ptrs(state, n, dev, "state")
    _want(obs, "obs", torch.float32, (n, F), dev, align=16)
    kp = None
    if init_mode != 0:
        _want(keys, "keys", torch.int32, (n, 2), dev, align=8)
        kp = keys.data_ptr()
    sums = n_done = traj = None
    if with_sums:
        sums = torch.empty((7, n), dtype=torch.float32, device=dev)
        n_done = torch.empty((n,), dtype=torch.int32, device=dev)
    tp = None
    if store_traj:
        f32 = dict(dtype=torch.float32, device=dev)
        traj = (torch.empty((length, n, F), **f32),
                torch.empty((length, n), dtype=torch.int32, device=dev),
                torch.empty((length, n), **f32),
                torch.empty((length, n), dtype=torch.bool, device=dev),
                torch.empty((12, length, n), **f32))
        tp = ctypes.byref(_TrajPtrs(*(t.data_ptr() for t in traj)))
    na = None
    if net is not None:
        na, logp, value, key_out, _keep = _net_args(
            net, n, length, F, dev, 4, store_traj)
    p, _p_keep = _params(params, n, dev)
    lib = _load()["nakamoto"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k2_stream(
            ctypes.byref(sp), obs.data_ptr(), kp, init_mode, n, length,
            ctypes.byref(p), policy_id, int(strict_match), int(unit_obs),
            int(extend_obs), None if sums is None else sums.data_ptr(),
            None if n_done is None else n_done.data_ptr(), tp,
            None if na is None else ctypes.byref(na), _stream(dev))
    _check(rc, lib, "cpr_k23_error_string", "K2 stream")
    launches["K2"] += 1
    if net is not None:
        launches["K11-act"] += 1
        if traj is not None:
            traj = traj + (logp, value, key_out)
    return sums, n_done, traj


def step_lanes(state, obs, actions, admit_mask, fresh_state, fresh_obs,
               step_mask, params, strict_match: bool, unit_obs: bool,
               extend_obs: bool = False):
    """K3: one tick of the resident lane block; the carry (`state`,
    `obs`) is updated IN PLACE. Returns (out_obs [L, F], reward [L],
    done [L] bool, info [12, L]), F = 4 (6 with `extend_obs`)."""
    dev = obs.device
    if dev.type != "cuda":
        raise ValueError("K3 takes CUDA tensors")
    n = obs.shape[0]
    F = 6 if extend_obs else 4
    sp = _state_ptrs(state, n, dev, "state")
    fp = _state_ptrs(fresh_state, n, dev, "fresh_state")
    _want(obs, "obs", torch.float32, (n, F), dev, align=16)
    _want(fresh_obs, "fresh_obs", torch.float32, (n, F), dev, align=16)
    _want(actions, "actions", torch.int32, (n,), dev)
    _want(admit_mask, "admit_mask", torch.bool, (n,), dev, align=1)
    _want(step_mask, "step_mask", torch.bool, (n,), dev, align=1)
    out_obs = torch.empty((n, F), dtype=torch.float32, device=dev)
    reward = torch.empty((n,), dtype=torch.float32, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    info = torch.empty((12, n), dtype=torch.float32, device=dev)
    p, _p_keep = _params(params, n, dev)
    lib = _load()["nakamoto"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k3_step_lanes(
            ctypes.byref(sp), obs.data_ptr(), actions.data_ptr(),
            admit_mask.data_ptr(), ctypes.byref(fp), fresh_obs.data_ptr(),
            step_mask.data_ptr(), n, ctypes.byref(p), int(strict_match),
            int(unit_obs), int(extend_obs), out_obs.data_ptr(),
            reward.data_ptr(),
            done.data_ptr(), info.data_ptr(), _stream(dev))
    _check(rc, lib, "cpr_k23_error_string", "K3 step_lanes")
    launches["K3"] += 1
    return out_obs, reward, done, info


# -- K4 / K5 ------------------------------------------------------------------

def _sweep_table(table, what: str) -> _SweepTable:
    """Check a `cpr_tpu_torch.mdp.explicit.TensorMDP` (rows sorted by
    segment, with the segment index) for the sweep kernels and point a
    `_SweepTable` at it."""
    L = table
    dev = L.prob.device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
    if L.prob.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: dtype {L.prob.dtype}, expected "
                         "float32 or float64")
    S, T, n_seg = L.n_states, L.prob.shape[0], L.seg_act.shape[0]
    i32 = torch.int32
    _want(L.state_seg, "state_seg", i32, (S + 1,), dev)
    _want(L.seg_ptr, "seg_ptr", i32, (n_seg + 1,), dev)
    _want(L.seg_act, "seg_act", i32, (n_seg,), dev)
    _want(L.seg_valid, "seg_valid", torch.uint8, (n_seg,), dev, align=1)
    _want(L.dst, "dst", i32, (T,), dev)
    for f in ("prob", "reward", "progress"):
        _want(getattr(L, f), f, L.prob.dtype, (T,), dev)
    return _SweepTable(
        L.state_seg.data_ptr(), L.seg_ptr.data_ptr(), L.seg_act.data_ptr(),
        L.seg_valid.data_ptr(), L.dst.data_ptr(), L.prob.data_ptr(),
        L.reward.data_ptr(), L.progress.data_ptr(), S, L.n_actions,
        int(L.prob.dtype == torch.float64))


def _loop_ctl(ctl, delta, resid, resid_len, can_stop, stop_delta, max_iter,
              dtype, dev) -> _LoopCtl:
    _want(ctl, "ctl", torch.int64, (4,), dev, align=8)
    _want(delta, "delta", dtype, (1,), dev)
    rp = None
    if resid_len > 0:
        _want(resid, "resid", dtype, (resid.shape[0],), dev)
        if resid.shape[0] < resid_len:
            raise ValueError(f"resid: {resid.shape[0]} slots, "
                             f"expected {resid_len}")
        rp = resid.data_ptr()
    return _LoopCtl(ctl.data_ptr(), delta.data_ptr(), rp, resid_len,
                    int(can_stop), float(stop_delta), int(max_iter))


def vi_sweeps(table, discount: float, value, prog, policy, ctl, delta,
              resid, resid_len: int, first: int, count: int, *,
              stop_delta: float, max_iter: int, can_stop: bool):
    """K4: enqueue `count` Bellman sweeps over `table` (a TensorMDP on
    the card). Global sweep g = first + i reads (value[g % 2],
    prog[g % 2]) and writes the other buffer of each pair and `policy`
    [S] int32. The loop state lives on the device: `ctl` int64 [4]
    (max-delta bits, sweeps done, stop flag, blocks done; zero before
    the first sweep), `delta` [1] the last sweep's max |V'-V|, and
    `resid` the ring of the last `resid_len` deltas. With `can_stop`, a
    sweep whose delta is <= stop_delta, or that reaches max_iter sweeps,
    sets the stop flag, and the launches after it return at once."""
    tb = _sweep_table(table, "K4")
    dev, dt, S = table.prob.device, table.prob.dtype, table.n_states
    for name, pair in (("value", value), ("prog", prog)):
        for j, t in enumerate(pair):
            _want(t, f"{name}[{j}]", dt, (S,), dev)
    _want(policy, "policy", torch.int32, (S,), dev)
    c = _loop_ctl(ctl, delta, resid, resid_len, can_stop, stop_delta,
                  max_iter, dt, dev)
    lib = _load()["mdp"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k4_vi_sweeps(
            ctypes.byref(tb), ctypes.byref(c), float(discount),
            value[0].data_ptr(), value[1].data_ptr(), prog[0].data_ptr(),
            prog[1].data_ptr(), policy.data_ptr(), first, count,
            _stream(dev))
    _check(rc, lib, "cpr_k45_error_string", "K4 vi_sweep")
    launches["K4"] += count


def pe_sweeps(table, policy, discount: float, rew, prog, ctl, delta,
              first: int, count: int, *, theta: float, max_iter: int):
    """K5: enqueue `count` policy-evaluation sweeps of the fixed `policy`
    [S] int32 (-1: no action), each summing only the state's on-policy
    segment; buffers and loop state as in `vi_sweeps`, the stop rule
    delta <= theta or max_iter sweeps."""
    tb = _sweep_table(table, "K5")
    dev, dt, S = table.prob.device, table.prob.dtype, table.n_states
    _want(policy, "policy", torch.int32, (S,), dev)
    for name, pair in (("rew", rew), ("prog", prog)):
        for j, t in enumerate(pair):
            _want(t, f"{name}[{j}]", dt, (S,), dev)
    c = _loop_ctl(ctl, delta, None, 0, True, theta, max_iter, dt, dev)
    lib = _load()["mdp"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k5_pe_sweeps(
            ctypes.byref(tb), ctypes.byref(c), policy.data_ptr(),
            float(discount), rew[0].data_ptr(), rew[1].data_ptr(),
            prog[0].data_ptr(), prog[1].data_ptr(), first, count,
            _stream(dev))
    _check(rc, lib, "cpr_k45_error_string", "K5 pe_sweep")
    launches["K5"] += count


# -- K7 -----------------------------------------------------------------------

def grid_vi_sweeps(table, probs, valid, live, discount: float, value, prog,
                   policy, dbits, steps: int):
    """K7: enqueue `steps` Bellman sweeps of the live grid points over
    `table`'s structure. `probs` [G, T] and `valid` [G, n_seg] uint8 are
    the points' probability columns (in the table's row order) and
    segment validity; `live` [n_live] int32 the points to sweep. Sweep i
    reads (value[i % 2], prog[i % 2]) and writes the other buffer of each
    [G, S] pair and `policy` [G, S] int32, for live points only; the
    point's max |V'-V| goes, as float bits, into `dbits[g, i]` (int64
    [G, steps], zeroed by the caller)."""
    tb = _sweep_table(table, "K7")
    dev, dt, S = table.prob.device, table.prob.dtype, table.n_states
    T, n_seg = int(table.prob.shape[0]), int(table.seg_act.shape[0])
    G = int(probs.shape[0])
    _want(probs, "probs", dt, (G, T), dev)
    _want(valid, "valid", torch.uint8, (G, n_seg), dev, align=1)
    _want(live, "live", torch.int32, (live.shape[0],), dev)
    for name, pair in (("value", value), ("prog", prog)):
        for j, t in enumerate(pair):
            _want(t, f"{name}[{j}]", dt, (G, S), dev)
    _want(policy, "policy", torch.int32, (G, S), dev)
    _want(dbits, "dbits", torch.int64, (G, steps), dev, align=8)
    lib = _load()["mdp"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k7_grid_sweeps(
            ctypes.byref(tb), probs.data_ptr(), valid.data_ptr(),
            live.data_ptr(), int(live.shape[0]), T, n_seg, float(discount),
            value[0].data_ptr(), value[1].data_ptr(), prog[0].data_ptr(),
            prog[1].data_ptr(), policy.data_ptr(), dbits.data_ptr(), steps,
            _stream(dev))
    _check(rc, lib, "cpr_k45_error_string", "K7 grid_sweep")
    launches["K7"] += steps


# -- K6 -----------------------------------------------------------------------

RTDP_MAX_BATCH = 1984  # 24 bytes of shared memory a walker, under 48 KB


def rtdp_walkers(table, words, V, P, cdf, *, graph: bool, max_steps: int,
                 batch: int, cap: int, eps: float, restart_p: float,
                 discount: float, stop_delta: float, decay: float) -> dict:
    """K6: the whole RTDP walk (`explicit._rtdp_walk`) in one launch over
    `table` (a float32 TensorMDP on the card). `words` [2] int32 is the
    key (read on the host), `V`/`P` [S] float32 are updated in place,
    `cdf` [S] float32 is the start CDF. Returns dict(V, P, visits [S],
    buf_s [cap], buf_pri [cap], s [batch], t, resid); reading t and
    resid synchronizes."""
    tb = _sweep_table(table, "K6")
    dev, S = table.prob.device, table.n_states
    if table.prob.dtype != torch.float32:
        raise ValueError("K6 takes float32 tables")
    if not 0 < batch <= RTDP_MAX_BATCH:
        raise ValueError(f"K6: batch {batch} outside 1..{RTDP_MAX_BATCH}")
    if graph and cap <= 0:
        raise ValueError("K6: graph mode needs a buffer (cap > 0)")
    for name, t in (("V", V), ("P", P), ("cdf", cdf)):
        _want(t, name, torch.float32, (S,), dev)
    i32, f32 = dict(dtype=torch.int32, device=dev), dict(
        dtype=torch.float32, device=dev)
    visits = torch.zeros(S, **i32)
    n = max(cap, 1)
    buf_s = [torch.zeros(n, **i32), torch.zeros(n, **i32)]
    buf_pri = [torch.full((n,), float("-inf"), **f32),
               torch.full((n,), float("-inf"), **f32)]
    walkers = torch.empty(batch, **i32)
    t_out = torch.zeros(1, dtype=torch.int64, device=dev)
    resid = torch.zeros(1, **f32)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in words.reshape(2).tolist())
    args = _RtdpArgs(
        V.data_ptr(), P.data_ptr(), visits.data_ptr(),
        (_p * 2)(*(b.data_ptr() for b in buf_s)),
        (_p * 2)(*(b.data_ptr() for b in buf_pri)), walkers.data_ptr(),
        cdf.data_ptr(), t_out.data_ptr(), resid.data_ptr(), int(max_steps),
        k0, k1, batch, cap if graph else 0, int(graph), 0, eps, restart_p,
        discount, stop_delta, decay)
    threads = min(1024, -(-max(batch, cap if graph else 0) // 32) * 32)
    lib = _load()["rtdp"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k6_rtdp(ctypes.byref(tb), ctypes.byref(args),
                             table.max_segment(), threads, _stream(dev))
    _check(rc, lib, "cpr_k6_error_string", "K6 rtdp")
    launches["K6"] += 1
    return dict(V=V, P=P, visits=visits, buf_s=buf_s[0][:cap],
                buf_pri=buf_pri[0][:cap], s=walkers, t=int(t_out[0]),
                resid=float(resid[0]))


# -- K8 / K10 -----------------------------------------------------------------

def check_dag_modes(name, W, P, ring, masks, lifted) -> None:
    """The DAG kernels' limits: ring windows of at most `_MAX_WINDOW`
    slots with ancestry planes, no lifting, at most `_MAX_PARENTS`
    parent slots."""
    if not (ring and masks) or lifted:
        raise NotImplementedError(
            f"{name} in full mode (window=None) or without ancestry planes "
            "has no CUDA kernel yet (ROADMAP item 8c); pass window=, or run "
            "the plain version on the CPU")
    if not 0 < W <= _MAX_WINDOW or not 0 < P <= _MAX_PARENTS:
        raise NotImplementedError(
            f"{name}: the DAG kernels hold windows of at most {_MAX_WINDOW} "
            f"slots and at most {_MAX_PARENTS} parent slots, this one has "
            f"{W} and {P} (ROADMAP item 8c)")


def check_quorum_modes(name, C, R, width) -> None:
    """K9's limits: a candidate frame of at most `_MAX_FRAME` (k <= 12 for
    Tailstorm and Stree), a release scan of at most `_MAX_WINDOW`
    positions, parent rows of at most 16 leaves."""
    if not (0 < C <= _MAX_FRAME and 0 < R <= _MAX_WINDOW
            and 0 < width <= 16):
        raise NotImplementedError(
            f"{name}: the quorum kernels hold candidate frames of at most "
            f"{_MAX_FRAME}, release scans of at most {_MAX_WINDOW} and rows "
            f"of at most 16 leaves, this one has {C}, {R} and {width} "
            "(ROADMAP item 8c)")


def check_spar_modes(name, k) -> None:
    """K10-spar's limit: the release selects the k + 8 oldest votes of
    its block in one top-k of at most 16 (csrc/dag.cuh kMaxTopK), so
    k <= 8."""
    if not 2 <= k <= 8:
        raise NotImplementedError(
            f"{name}: K10-spar's release selection holds k + 8 <= 16 votes "
            f"(k <= 8), this one has k = {k} (ROADMAP item 8c)")


def _dag_ptrs(dag, dev, name) -> _DagPtrs:
    """Check a lane-batched core.dag.Dag in ring mode with ancestry planes
    for the DAG kernels and point a `_DagPtrs` at it."""
    from cpr_tpu_torch.core.dag import PLANE_DTYPES
    L, W, P = dag.n_lanes, dag.capacity, dag.max_parents
    check_dag_modes(name, W, P, dag.is_ring, dag.has_masks, dag.lifted)
    ptrs = _DagPtrs()
    for i, plane in enumerate(dag.parents):
        _want(plane, f"{name}.parents[{i}]", torch.int32, (L, W), dev)
        ptrs.parents[i] = plane.data_ptr()
    for f in _DAG_PLANES:
        t = getattr(dag, f)
        shape = ((L,) if f in ("live_floor", "n", "overflow") else
                 (L, W, W) if f in ("chain", "closure") else (L, W))
        _want(t, f"{name}.{f}", PLANE_DTYPES[f], shape, dev,
              align=1 if PLANE_DTYPES[f] == torch.bool else 4)
        setattr(ptrs, f, t.data_ptr())
    ptrs.W, ptrs.P = W, P
    return ptrs


def _env_ptrs(env, state, n, dev, name) -> _EnvPtrs:
    ptrs = _EnvPtrs()
    ints = env.int_fields
    floats = ("time", "last_reward_attacker", "last_reward_defender",
              "last_progress", "last_chain_time", "last_sim_time")
    for j, f in enumerate(ints):
        t = getattr(state, f)
        _want(t, f"{name}.{f}", torch.int32, (n,), dev)
        ptrs.i[j] = t.data_ptr()
    for j, f in enumerate(floats):
        t = getattr(state, f)
        _want(t, f"{name}.{f}", torch.float32, (n,), dev)
        ptrs.f[j] = t.data_ptr()
    for j, f in enumerate(env.bool_fields):
        t = getattr(state, f)
        _want(t, f"{name}.{f}", torch.bool, (n,), dev, align=1)
        ptrs.b[j] = t.data_ptr()
    for f in env.plane_fields:  # the one per-slot plane: `stale`
        t = getattr(state, f)
        _want(t, f"{name}.{f}", torch.bool, (n, env.capacity), dev, align=1)
        ptrs.stale = t.data_ptr()
    _want(state.key, f"{name}.key", torch.int32, (n, 2), dev, align=8)
    ptrs.key = state.key.data_ptr()
    return ptrs


def _env_config(env) -> _EnvConfig:
    cfg = env.kernel_config()
    unknown = set(cfg) - {f for f, _ in _EnvConfig._fields_}
    if unknown:  # ctypes would keep them as plain attributes
        raise ValueError(f"{env.kernel_name}: no EnvConfig field {unknown}")
    return _EnvConfig(unit=int(env.unit_observation),
                      **{f: int(v) for f, v in cfg.items()})


def _k10(env, entry: str):
    """The env's K10 library (`env.kernel_lib`) and its `entry` point."""
    lib = _load()[f"k10_{env.kernel_lib}"]
    return lib, getattr(lib, f"cpr_k10_{env.kernel_lib}_{entry}")


def dag_stream(env, state, obs, keys, init_mode: int, length: int, params,
               policy_id: int, with_sums: bool = True,
               store_traj: bool = False, net=None, extend_obs: bool = False):
    """K10 (the library `env.kernel_lib`): `length` auto-resetting
    steps of every lane under the scripted policy `policy_id` or the
    `net` (K11-act, as in `stream`), updating the carry (`state`, a DAG
    env's state on the card, and `obs` [L, F]) IN PLACE; F the env's
    observation length, + 2 with `extend_obs`; init_mode as in `stream`.
    Returns (sums [7, L], n_done [L], traj) as `stream` does, traj obs
    [T, L, F]."""
    dev = obs.device
    if dev.type != "cuda":
        raise ValueError(f"{env.kernel_name} takes CUDA tensors")
    n = obs.shape[0]
    F = env.observation_length + (2 if extend_obs else 0)
    dp = _dag_ptrs(state.dag, dev, "state.dag")
    ep = _env_ptrs(env, state, n, dev, "state")
    _want(obs, "obs", torch.float32, (n, F), dev)
    kp = None
    if init_mode != 0:
        _want(keys, "keys", torch.int32, (n, 2), dev, align=8)
        kp = keys.data_ptr()
    sums = n_done = traj = None
    if with_sums:
        sums = torch.empty((7, n), dtype=torch.float32, device=dev)
        n_done = torch.empty((n,), dtype=torch.int32, device=dev)
    tp = None
    if store_traj:
        f32 = dict(dtype=torch.float32, device=dev)
        traj = (torch.empty((length, n, F), **f32),
                torch.empty((length, n), dtype=torch.int32, device=dev),
                torch.empty((length, n), **f32),
                torch.empty((length, n), dtype=torch.bool, device=dev),
                torch.empty((12, length, n), **f32))
        tp = ctypes.byref(_TrajPtrs(*(t.data_ptr() for t in traj)))
    na = None
    if net is not None:
        na, logp, value, key_out, _keep = _net_args(
            net, n, length, F, dev, 24, store_traj)
    (p, _p_keep), c = _params(params, n, dev), _env_config(env)
    lib, fn = _k10(env, "stream")
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(dp), ctypes.byref(ep), obs.data_ptr(), kp,
                init_mode, n, length, ctypes.byref(p), ctypes.byref(c),
                policy_id, int(extend_obs),
                None if sums is None else sums.data_ptr(),
                None if n_done is None else n_done.data_ptr(), tp,
                None if na is None else ctypes.byref(na), _stream(dev))
    _check(rc, lib, f"cpr_k10_{env.kernel_lib}_error_string",
           f"{env.kernel_name} stream")
    launches[env.kernel_name] += 1
    if net is not None:
        launches["K11-act"] += 1
        if traj is not None:
            traj = traj + (logp, value, key_out)
    return sums, n_done, traj


def dag_step_lanes(env, state, obs, actions, admit_mask, fresh_state,
                   fresh_obs, step_mask, params, extend_obs: bool = False):
    """K10 one tick of the resident lane block; the carry
    (`state`, `obs`) is updated in place. Returns (out_obs [L, F],
    reward [L], done [L] bool, info [12, L]); F as in `dag_stream`."""
    dev = obs.device
    if dev.type != "cuda":
        raise ValueError(f"{env.kernel_name} takes CUDA tensors")
    n = obs.shape[0]
    F = env.observation_length + (2 if extend_obs else 0)
    dp = _dag_ptrs(state.dag, dev, "state.dag")
    ep = _env_ptrs(env, state, n, dev, "state")
    fdp = _dag_ptrs(fresh_state.dag, dev, "fresh_state.dag")
    fep = _env_ptrs(env, fresh_state, n, dev, "fresh_state")
    if fresh_state.dag.capacity != state.dag.capacity or \
            fresh_state.dag.max_parents != state.dag.max_parents:
        raise ValueError("fresh_state: another DAG shape than the carry's")
    _want(obs, "obs", torch.float32, (n, F), dev)
    _want(fresh_obs, "fresh_obs", torch.float32, (n, F), dev)
    _want(actions, "actions", torch.int32, (n,), dev)
    _want(admit_mask, "admit_mask", torch.bool, (n,), dev, align=1)
    _want(step_mask, "step_mask", torch.bool, (n,), dev, align=1)
    out_obs = torch.empty((n, F), dtype=torch.float32, device=dev)
    reward = torch.empty((n,), dtype=torch.float32, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    info = torch.empty((12, n), dtype=torch.float32, device=dev)
    (p, _p_keep), c = _params(params, n, dev), _env_config(env)
    lib, fn = _k10(env, "step_lanes")
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(dp), ctypes.byref(ep), obs.data_ptr(),
                actions.data_ptr(), admit_mask.data_ptr(), ctypes.byref(fdp),
                ctypes.byref(fep), fresh_obs.data_ptr(), step_mask.data_ptr(),
                n, ctypes.byref(p), ctypes.byref(c), int(extend_obs),
                out_obs.data_ptr(),
                reward.data_ptr(), done.data_ptr(), info.data_ptr(),
                _stream(dev))
    _check(rc, lib, f"cpr_k10_{env.kernel_lib}_error_string",
           f"{env.kernel_name} step_lanes")
    launches[env.kernel_name] += 1
    return out_obs, reward, done, info


def quorum_check(dag, inputs: dict, cfg: dict) -> dict:
    """K9's check kernel (csrc/quorum_check.cu) on `dag` (ring window with
    ancestry planes, on the card, read only). `inputs` as
    `envs.quorum.check_plain` takes them: cand, own [L, W] bool, seen,
    score [L, W] float32, stale [L, W] bool, pub, priv [L] int32; `cfg` its
    options (`_CHECK_CFG`). Returns the dict `check_plain` returns."""
    dev = dag.device
    if dev.type != "cuda":
        raise ValueError("K9 takes CUDA tensors")
    L, W = dag.n_lanes, dag.capacity
    C, width = int(cfg["C"]), int(cfg["width"])
    check_quorum_modes("K9 check", C, int(cfg["R"]), width)
    dp = _dag_ptrs(dag, dev, "dag")
    for f, dt in (("cand", torch.bool), ("own", torch.bool),
                  ("seen", torch.float32), ("score", torch.float32),
                  ("stale", torch.bool)):
        _want(inputs[f], f, dt, (L, W), dev,
              align=1 if dt == torch.bool else 4)
    for f in ("pub", "priv"):
        _want(inputs[f], f, torch.int32, (L,), dev)
    cin = _CheckIn(*(inputs[f].data_ptr() for f in (
        "cand", "own", "seen", "score", "stale", "pub", "priv")))
    ccfg = _CheckCfg(*(int(cfg[f]) for f in _CHECK_CFG))
    b = dict(dtype=torch.bool, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = dict(cidx=torch.empty((L, C), **i32),
               cvalid=torch.empty((L, C), **b),
               abits=torch.empty((L, C, C), **b),
               found=torch.empty((3, L), **b),
               leaves=torch.empty((3, L, C), **b),
               row=torch.empty((3, L, width), **i32),
               ovr=torch.empty((L, W), **b), mat=torch.empty((L, W), **b),
               rfound=torch.empty((L,), **b), head=torch.empty((L,), **i32),
               stale=torch.empty((L, W), **b))
    cout = _CheckOut(*(out[f].data_ptr() for f in (
        "cidx", "cvalid", "abits", "found", "leaves", "row", "ovr", "mat",
        "rfound", "head", "stale")))
    lib = _load()["quorum"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k9_quorum_check(ctypes.byref(dp), ctypes.byref(cin),
                                     ctypes.byref(ccfg), L,
                                     ctypes.byref(cout), _stream(dev))
    _check(rc, lib, "cpr_k9_error_string", "K9 quorum_check")
    launches["K9"] += 1
    return out


def dag_script(dag, ops, args, fargs):
    """K8's check kernel: the script of `core.dag.make_script` on `dag`
    (ring window with ancestry planes, on the card), updated in place.
    `ops` [T] host int32; `args` [T, L, 8 + P] int32, `fargs` [T, L, 4]
    float32 on the card. Returns (regs [L, 8], out [T, L, 4])."""
    from cpr_tpu_torch.core.dag import RING_OPS_Q, SCRIPT_OUT, SCRIPT_REGS
    dev = dag.device
    if dev.type != "cuda":
        raise ValueError("K8 takes CUDA tensors")
    L, P = dag.n_lanes, dag.max_parents
    dp = _dag_ptrs(dag, dev, "dag")
    ops_t = torch.as_tensor(ops, dtype=torch.int32)
    if not bool(torch.isin(ops_t, torch.tensor(RING_OPS_Q)).all()):
        raise NotImplementedError(
            "K8's check kernel runs the ring-window ops only; the walk-based "
            "queries are full mode (ROADMAP item 8c)")
    T = int(ops_t.shape[0])
    ops_d = ops_t.to(dev)
    _want(args, "args", torch.int32, (T, L, 8 + P), dev)
    _want(fargs, "fargs", torch.float32, (T, L, 4), dev)
    regs = torch.empty((L, SCRIPT_REGS), dtype=torch.int32, device=dev)
    out = torch.empty((T, L, SCRIPT_OUT), dtype=torch.int32, device=dev)
    lib = _load()["dag"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k8_dag_script(ctypes.byref(dp), ops_d.data_ptr(), T,
                                   args.data_ptr(), 8 + P, fargs.data_ptr(),
                                   L, regs.data_ptr(), out.data_ptr(),
                                   _stream(dev))
    _check(rc, lib, "cpr_k8_error_string", "K8 dag_script")
    launches["K8"] += 1
    return regs, out


# -- K11 ----------------------------------------------------------------------

def actor_check(net, obs, alpha=None, gamma=None, k_act=None, *,
                warp: bool):
    """K11-act's check kernel: the actor-critic `net` (a `train.ppo.
    ActorCritic` on the card) on `obs` [L, F] (CUDA), with each lane's
    `alpha`, `gamma` [L] appended when given (extend_obs), in warp mode
    (as K10 runs it) or thread mode (as K2 does); the draw greedy, or
    sampled with `k_act` [2], the step's key. Returns (logits [L, A],
    value [L], action [L] int32, logp [L])."""
    dev = obs.device
    if dev.type != "cuda":
        raise ValueError("K11-act takes CUDA tensors")
    n, F = obs.shape
    _want(obs, "obs", torch.float32, (n, F), dev)
    width = F + (2 if alpha is not None else 0)
    if alpha is not None:
        _want(alpha, "alpha", torch.float32, (n,), dev)
        _want(gamma, "gamma", torch.float32, (n,), dev)
    from cpr_tpu_torch.train.ppo import NetPolicy
    pol = NetPolicy(net, greedy=k_act is None, key=k_act)
    na, _, _, _, _keep = _net_args(pol, n, 0, width, dev, 24, False)
    A = net.n_actions
    f32 = dict(dtype=torch.float32, device=dev)
    logits = torch.empty((n, A), **f32)
    value = torch.empty((n,), **f32)
    action = torch.empty((n,), dtype=torch.int32, device=dev)
    logp = torch.empty((n,), **f32)
    out = (_p * 4)(logits.data_ptr(), value.data_ptr(), action.data_ptr(),
                   logp.data_ptr())
    lib = _load()["actor"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k11_actor_check(
            ctypes.byref(na), obs.data_ptr(), F,
            None if alpha is None else alpha.data_ptr(),
            None if gamma is None else gamma.data_ptr(), n, int(warp), out,
            _stream(dev))
    _check(rc, lib, "cpr_k11_act_error_string", "K11-act check")
    launches["K11-act"] += 1
    return logits, value, action, logp


def gae(reward, value, done, last_value, gamma: float, lam: float):
    """K11-gae: the reverse GAE scan over reward/value [T, N] float32,
    done [T, N] bool, last_value [N]. Returns (adv, target) [T, N]."""
    dev = reward.device
    if dev.type != "cuda":
        raise ValueError("K11-gae takes CUDA tensors")
    T, N = reward.shape
    for name, t, dt in (("reward", reward, torch.float32),
                        ("value", value, torch.float32),
                        ("done", done, torch.bool)):
        _want(t, name, dt, (T, N), dev, align=1 if dt == torch.bool else 4)
    _want(last_value, "last_value", torch.float32, (N,), dev)
    adv = torch.empty((T, N), dtype=torch.float32, device=dev)
    target = torch.empty((T, N), dtype=torch.float32, device=dev)
    lib = _load()["gae"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k11_gae(reward.data_ptr(), value.data_ptr(),
                             done.data_ptr(), last_value.data_ptr(), T, N,
                             float(torch.tensor(gamma, dtype=torch.float32)),
                             float(torch.tensor(gamma * lam,
                                                dtype=torch.float32)),
                             adv.data_ptr(), target.data_ptr(), _stream(dev))
    _check(rc, lib, "cpr_k11_gae_error_string", "K11-gae")
    launches["K11-gae"] += 1
    return adv, target


def _loss_inputs(logits, value, action, old_logp, old_value, adv, target):
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError("K11-loss takes CUDA tensors")
    B, A = logits.shape
    if not 0 < A <= 24:
        raise NotImplementedError(f"K11-loss takes at most 24 actions, "
                                  f"got {A}")
    _want(logits, "logits", torch.float32, (B, A), dev)
    _want(action, "action", torch.int32, (B,), dev)
    for name, t in (("value", value), ("old_logp", old_logp),
                    ("old_value", old_value), ("adv", adv),
                    ("target", target)):
        _want(t, name, torch.float32, (B,), dev)
    ptrs = (_p * 7)(*(t.data_ptr() for t in (
        logits, value, action, old_logp, old_value, adv, target)))
    return dev, B, A, ptrs


def ppo_loss_fwd(logits, value, action, old_logp, old_value, adv, target,
                 clip_eps: float, vf_coef: float, ent_coef: float):
    """K11-loss forward over a minibatch (CUDA, contiguous): logits
    [B, A], value, old_logp, old_value, adv, target [B] float32, action
    [B] int32. Returns (out [5]: total, pg_loss, v_loss, entropy,
    approx_kl; stats [2]: the advantages' mean and std + 1e-8)."""
    dev, B, A, ptrs = _loss_inputs(logits, value, action, old_logp,
                                   old_value, adv, target)
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    stats = torch.empty((2,), dtype=torch.float32, device=dev)
    lib = _load()["loss"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k11_loss_fwd(ptrs, B, A, clip_eps, vf_coef, ent_coef,
                                  out.data_ptr(), stats.data_ptr(),
                                  _stream(dev))
    _check(rc, lib, "cpr_k11_loss_error_string", "K11-loss forward")
    launches["K11-loss"] += 1
    return out, stats


def ppo_loss_bwd(logits, value, action, old_logp, old_value, adv, target,
                 stats, g_total, clip_eps: float, vf_coef: float,
                 ent_coef: float):
    """K11-loss backward: the forward's inputs and `stats`, the total's
    incoming gradient `g_total` (a 0-dim or [1] CUDA tensor). Returns
    (dlogits [B, A], dvalue [B])."""
    dev, B, A, ptrs = _loss_inputs(logits, value, action, old_logp,
                                   old_value, adv, target)
    _want(stats, "stats", torch.float32, (2,), dev)
    g = g_total.reshape(1).to(torch.float32).contiguous()
    dlogits = torch.empty((B, A), dtype=torch.float32, device=dev)
    dvalue = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _load()["loss"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k11_loss_bwd(ptrs, B, A, clip_eps, vf_coef, ent_coef,
                                  stats.data_ptr(), g.data_ptr(),
                                  dlogits.data_ptr(), dvalue.data_ptr(),
                                  _stream(dev))
    _check(rc, lib, "cpr_k11_loss_error_string", "K11-loss backward")
    launches["K11-loss"] += 1
    return dlogits, dvalue


def adam(flat, grad, mu, nu, *, neg_lr, bc1, bc2, b1, b2, omb1, omb2, eps,
         max_norm):
    """K11-adam: one clipped Adam step over the flat vector (CUDA
    float32 [n]); `flat`, `mu` and `nu` are updated in place. The
    scalars are `optim.ClipAdam.scalars`'. Returns the gradient's global
    norm [1]."""
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError("K11-adam takes CUDA tensors")
    n = flat.shape[0]
    for name, t in (("flat", flat), ("grad", grad), ("mu", mu), ("nu", nu)):
        _want(t, name, torch.float32, (n,), dev)
    norm = torch.empty((1,), dtype=torch.float32, device=dev)
    lib = _load()["adam"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k11_adam(flat.data_ptr(), grad.data_ptr(),
                              mu.data_ptr(), nu.data_ptr(), n, neg_lr, bc1,
                              bc2, b1, b2, omb1, omb2, eps, max_norm,
                              norm.data_ptr(), _stream(dev))
    _check(rc, lib, "cpr_k11_adam_error_string", "K11-adam")
    launches["K11-adam"] += 1
    return norm


# -- K12 / K13 ----------------------------------------------------------------

SCAN_MAX_LOOKBACK = 256      # csrc/netsim_scan.cu: 8 ring slots a thread
# the event engine's protocol kernels, by the protocol they run
PROTOCOL_KERNELS = {"bk": "bk", "ethereum-whitepaper": "eth",
                    "ethereum-byzantium": "eth", "spar": "spar"}
EVENT_MAX_SMEM = 227 * 1024  # an H100 block's dynamic shared memory


def _net_planes(cn, logw, dev):
    """The topology's planes on `dev` and their struct (the caller keeps
    the tensors alive until the launch is queued)."""
    from cpr_tpu_torch.netsim.engine import check_kernel_nodes, planes
    check_kernel_nodes(cn.n, "the netsim")
    kind, p0, p1 = planes(cn, dev)
    logw = logw.to(dev, torch.float32).contiguous()
    keep = (kind, p0, p1, logw)
    return _NetPlanes(*(t.data_ptr() for t in keep), cn.n), keep


def _net_out(n_lanes, n, dev):
    i32 = dict(dtype=torch.int32, device=dev)
    out = {f: torch.empty(n_lanes, **i32) for f in _NET_OUT}
    out["sim_time"] = torch.empty(n_lanes, dtype=torch.float64, device=dev)
    out["node_act"] = torch.empty((n_lanes, n), **i32)
    out["reward"] = torch.empty((n_lanes, n), dtype=torch.float32, device=dev)
    out["exhausted"] = torch.empty(n_lanes, dtype=torch.bool, device=dev)
    return out, _NetOut(*(out[f].data_ptr() for f in _NET_OUT))


def _lane_inputs(keys, delays, what):
    if not keys.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    dev = keys.device
    n = keys.shape[0]
    _want(keys, "keys", torch.int32, (n, 2), dev, align=8)
    _want(delays, "delays", torch.float64, (n,), dev, align=8)
    return dev, n


def netsim_scan(cn, A: int, L: int, keys, delays) -> dict:
    """K12-scan: `keys` [lanes, 2] (64-bit mode keys) and activation
    `delays` [lanes] f64 on CUDA -> the lanes' outputs (engine.py's keys
    but progress/on_chain) for `A` activations and lookback `L` on the
    compiled network `cn`."""
    from cpr_tpu_torch.netsim.engine import log_compute, uniform_const_delay
    dev, n = _lane_inputs(keys, delays, "K12-scan")
    A, L = int(A), min(int(L), int(A))
    if A < 1 or not 1 <= L <= SCAN_MAX_LOOKBACK:
        raise ValueError(f"K12-scan: activations {A} >= 1 and lookback "
                         f"{L} in [1, {SCAN_MAX_LOOKBACK}] needed")
    pl, keep = _net_planes(cn, log_compute(cn, dev), dev)
    D = uniform_const_delay(cn)
    parents = torch.empty((n, A), dtype=torch.int32, device=dev)
    miners = torch.empty((n, A), dtype=torch.int32, device=dev)
    out, ptrs = _net_out(n, cn.n, dev)
    lib = _load()["netsim_scan"]
    with torch.cuda.device(dev):
        rc = lib.cpr_k12_scan(keys.data_ptr(), delays.data_ptr(),
                              parents.data_ptr(), miners.data_ptr(), n, A, L,
                              int(D is not None), D or 0.0,
                              ctypes.byref(pl), ctypes.byref(ptrs),
                              _stream(dev))
    _check(rc, lib, "cpr_k12_scan_error_string", "K12-scan")
    del keep
    launches["K12-scan"] += 1
    return out


def event_smem(M: int, F: int) -> int:
    """Shared memory of one K12-event/K13 lane (csrc/netsim_event.cuh
    `event_smem`): the queue (time, block/node, sequence, free list) and
    32 pending buffers."""
    return M * (8 + 3 * 4) + 32 * F * 4


def _ledger(n, B, M, F, S, A, WA, dev, attack):
    smem = event_smem(M, F)
    if smem > EVENT_MAX_SMEM:
        raise ValueError(f"netsim queue {M} and pending {F} need {smem} "
                         f"bytes of shared memory a lane, over "
                         f"{EVENT_MAX_SMEM}")
    planes = [torch.empty((n, B), dtype=torch.int32, device=dev)
              for _ in range(6 if attack else 5)]
    ptrs = [t.data_ptr() for t in planes] + ([] if attack else [None])
    return _Ledger(*ptrs, B, M, F, S, A, WA), planes


def _event_launch(name, lib_key, fn, errfn, cn, logw, A, B, M, F, S, WA,
                  keys, delays, policy=None, strict=True):
    dev, n = _lane_inputs(keys, delays, name)
    if policy is not None:
        _want(policy, "policy", torch.int32, (n,), dev)
    pl, keep = _net_planes(cn, logw, dev)
    led, planes = _ledger(n, B, M, F, S, A, WA, dev, policy is not None)
    lane_in = _LaneIn(keys.data_ptr(), delays.data_ptr(),
                      None if policy is None else policy.data_ptr(), n,
                      int(bool(strict)))
    out, ptrs = _net_out(n, cn.n, dev)
    lib = _load()[lib_key]
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(ctypes.byref(lane_in), ctypes.byref(led),
                              ctypes.byref(pl), int(cn.flooding),
                              ctypes.byref(ptrs), _stream(dev))
    _check(rc, lib, errfn, name)
    del keep, planes
    launches[name] += 1
    return out


def netsim_event(cn, A, B, M, F, S, keys, delays) -> dict:
    """K12-event: the event engine (Nakamoto) for `keys` [lanes, 2] and
    `delays` [lanes] f64 on CUDA, ledger capacity B, queue M, pending F,
    step cap S -> the lanes' outputs."""
    from cpr_tpu_torch.netsim.engine import log_compute
    return _event_launch("K12-event", "netsim_event", "cpr_k12_event",
                         "cpr_k12_event_error_string", cn,
                         log_compute(cn, keys.device), A, B, M, F, S, 0,
                         keys, delays)


def proto_smem(W: int, QW: int, U: int) -> int:
    """Shared memory a protocol kernel's lane adds to `event_smem`
    (csrc/netsim_event.cuh `proto_smem`): four scratch arrays of
    max(W, QW, U) entries and Ethereum's chain set."""
    return (4 * max(W, QW, U) + 7 + 6 * U) * 4


def netsim_event_protocol(cn, proto, A, B, M, F, S, keys, delays) -> dict:
    """K12-event-bk, K12-event-eth or K12-event-spar, by `proto`
    (`netsim.engine.Proto`): the event engine running that protocol for
    `keys` [lanes, 2] and `delays` [lanes] f64 on CUDA, ledger capacity B,
    queue M, pending F, step cap S -> the lanes' outputs with progress and
    on_chain."""
    from cpr_tpu_torch.netsim.engine import log_compute
    name = PROTOCOL_KERNELS.get(proto.protocol)
    if name is None:
        raise ValueError(f"no event kernel runs '{proto.protocol}'")
    kernel = f"K12-event-{name}"
    dev, n = _lane_inputs(keys, delays, kernel)
    N, QW, W, U = cn.n, proto.QW, proto.W, proto.U
    smem = event_smem(M, F) + proto_smem(W, QW, U)
    if smem > EVENT_MAX_SMEM:
        raise ValueError(f"{kernel}: queue {M}, pending {F} and window {W} "
                         f"need {smem} bytes of shared memory a lane, over "
                         f"{EVENT_MAX_SMEM}")
    pl, keep = _net_planes(cn, log_compute(cn, dev), dev)
    led, planes = _ledger(n, B, M, F, S, A, 0, dev, False)
    i32, f32 = torch.int32, torch.float32
    shapes = {"is_vote": ((n, B), i32), "nvotes": ((n, B), i32),
              "conf": ((n, B, N), i32), "conf_own": ((n, B, N), i32),
              "quorum": ((n, B, QW), i32)}
    if name == "bk":
        shapes.update(powh=((n, B), f32), lhash=((n, B), f32),
                      mybest=((n, B, N), f32), repl=((n, B, N), f32),
                      noprop=((n, B), i32))
    if name == "eth":
        shapes = {"work": ((n, B), i32), "uncles": ((n, B, U), i32)}
    bufs = {f: torch.empty(shape, dtype=dt, device=dev)
            for f, (shape, dt) in shapes.items()}
    out, ptrs = _net_out(n, N, dev)
    for f in ("progress", "on_chain"):
        bufs[f] = out[f] = torch.empty(n, dtype=torch.float64, device=dev)
    pr = _Proto(*(bufs[f].data_ptr() if f in bufs else None
                  for f in _PROTO_PLANES),
                proto.k, QW, W, U, int(proto.byz),
                int(proto.scheme == "block"))
    lane_in = _LaneIn(keys.data_ptr(), delays.data_ptr(), None, n, 1)
    lib = _load()[f"netsim_event_{name}"]
    with torch.cuda.device(dev):
        rc = getattr(lib, f"cpr_k12_event_{name}")(
            ctypes.byref(lane_in), ctypes.byref(led), ctypes.byref(pl),
            int(cn.flooding), ctypes.byref(pr), ctypes.byref(ptrs),
            _stream(dev))
    _check(rc, lib, f"cpr_k12_event_{name}_error_string", kernel)
    del keep, planes, bufs
    launches[kernel] += 1
    return out


def netsim_attack(cn, A, B, M, F, S, WA, keys, delays, alphas, policy,
                  strict_match) -> dict:
    """K13: the attacker at node 0, lane alphas [lanes] f32 and scripted
    policy ids [lanes] int32 (`envs.nakamoto.POLICY_NAMES` order) on
    CUDA; walk cap WA. Adds reward_attacker and reward_defender."""
    from cpr_tpu_torch.netsim.attack import attack_logits
    out = _event_launch("K13", "netsim_attack", "cpr_k13_attack",
                        "cpr_k13_error_string", cn, attack_logits(cn, alphas),
                        A, B, M, F, S, WA, keys, delays, policy, strict_match)
    out["reward_attacker"] = out["reward"][:, 0]
    out["reward_defender"] = out["reward"][:, 1:].sum(1)
    return out
