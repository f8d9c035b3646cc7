"""Native (C++) generic-MDP compiler bindings.

Drives the port's copy of the C++ BFS compiler
(cpr_tpu_torch/native/src/generic_compiler.cpp, built with g++ into
build/cpr_tpu_torch/ at first use) through ctypes, for the state spaces
the capstone needs (GhostDAG at millions of transitions). Same flags,
errors and output container as the JAX package's `compile_native`;
tests hold the two compiles' columns equal.
"""

from __future__ import annotations

import ctypes

import numpy as np

from cpr_tpu_torch.mdp.explicit import MDP
from cpr_tpu_torch.native import SRC, load_lib

_SRC = SRC / "generic_compiler.cpp"

_GC_MODES = {None: 0, "simple": 1, "judge": 2}


def lib() -> ctypes.CDLL:
    L = load_lib(_SRC, opt="-O3")
    if getattr(L, "_gmc_bound", False):
        return L
    L.gmc_compile.restype = ctypes.c_void_p
    L.gmc_compile.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64,
    ]
    for f in ("gmc_n_states", "gmc_n_transitions", "gmc_n_start"):
        getattr(L, f).restype = ctypes.c_int64
        getattr(L, f).argtypes = [ctypes.c_void_p]
    L.gmc_error.restype = ctypes.c_char_p
    L.gmc_error.argtypes = [ctypes.c_void_p]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    L.gmc_copy.restype = None
    L.gmc_copy.argtypes = [ctypes.c_void_p, i32p, i32p, i32p,
                           f64p, f64p, f64p]
    L.gmc_copy_start.restype = None
    L.gmc_copy_start.argtypes = [ctypes.c_void_p, i32p, f64p]
    L.gmc_free.restype = None
    L.gmc_free.argtypes = [ctypes.c_void_p]
    L._gmc_bound = True
    return L


def compile_native(
    proto: str = "ghostdag",
    *,
    k: int = 2,
    alpha: float,
    gamma: float,
    collect_garbage: str | None = "simple",
    dag_size_cutoff: int | None = None,
    traditional_height_cutoff: int | None = None,
    loop_honest: bool = False,
    merge_isomorphic: bool = True,
    truncate_common_chain: bool = True,
    reward_common_chain: bool = False,
    force_consider_own: bool = False,
    max_states: int = 50_000_000,
) -> MDP:
    """BFS-compile the generic model natively; same flags as
    `SingleAgent`, same MDP container out (numpy-backed columns).

    Protocols: bitcoin, ghostdag (k = cluster size), parallel (k =
    votes), ethereum / byzantium (k = uncle window h, default 7).
    """
    L = lib()
    h = L.gmc_compile(
        proto.encode(), k, alpha, gamma,
        -1 if dag_size_cutoff is None else dag_size_cutoff,
        -1 if traditional_height_cutoff is None
        else traditional_height_cutoff,
        _GC_MODES[collect_garbage], int(merge_isomorphic),
        int(truncate_common_chain), int(loop_honest),
        int(reward_common_chain), int(force_consider_own), max_states)
    if not h:
        raise RuntimeError(
            f"native compile failed: {L.gmc_error(None).decode()}")
    try:
        err = L.gmc_error(h)
        if err:
            raise RuntimeError(f"native compile failed: {err.decode()}")
        nt = L.gmc_n_transitions(h)
        ns = L.gmc_n_start(h)
        src = np.empty(nt, np.int32)
        act = np.empty(nt, np.int32)
        dst = np.empty(nt, np.int32)
        prob = np.empty(nt, np.float64)
        reward = np.empty(nt, np.float64)
        progress = np.empty(nt, np.float64)
        L.gmc_copy(h, src, act, dst, prob, reward, progress)
        sid = np.empty(ns, np.int32)
        sp = np.empty(ns, np.float64)
        L.gmc_copy_start(h, sid, sp)
        mdp = MDP(
            n_states=int(L.gmc_n_states(h)),
            n_actions=int(act.max()) + 1 if nt else 0,
            start={int(s): float(p) for s, p in zip(sid, sp)},
            src=src, act=act, dst=dst, prob=prob, reward=reward,
            progress=progress)
        # same invariant gate every Python-compiled table passes through
        # (compiler.py mdp() -> check()); vectorized, ~1s at 4M rows
        mdp.check()
        return mdp
    finally:
        L.gmc_free(h)


__all__ = ["compile_native", "lib"]
