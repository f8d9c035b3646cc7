"""Keyed environment registry + protocol-key parser (port of
cpr_tpu/envs/registry.py).

Reference counterpart: the protocol/attack-space registry and string keys
(simulator/protocols/cpr_protocols.ml:11-180) with the `of_key` grammar
(cpr_protocols.ml:786-903). The grammar is the JAX package's, whole,
and so are the families: `nakamoto`, `bk`, the `ethereum` families,
`spar`, `stree`, `sdag`, `tailstorm` and `tailstormjune`.
"""

from __future__ import annotations

import inspect
from typing import Callable

_REGISTRY: dict[str, Callable] = {}
_ENV_MEMO: dict = {}

_INFO = {
    "nakamoto": "Nakamoto consensus / longest chain",
    "bk": "Bk: k parallel PoW votes per block, leader-signed",
    "ethereum": "Ethereum PoW with uncles (whitepaper/byzantium presets)",
    "ethereum-whitepaper": "Ethereum PoW, whitepaper uncle rules",
    "ethereum-byzantium": "Ethereum PoW, byzantium uncle rules",
    "spar": "Simple parallel PoW (k PoW per block, k-1 votes)",
    "stree": "Parallel PoW with tree-structured votes",
    "sdag": "Parallel PoW with DAG-structured votes (k >= 2)",
    "tailstorm": "Tailstorm: summaries over depth-labelled vote trees",
    "tailstormjune": "Tailstorm, June'22 variant (W&B run 257 repro)",
}

# families the JAX package has and this package does not yet, with the
# ROADMAP item that brings them (none left)
_NOT_PORTED: dict[str, str] = {}


def register(key: str, factory: Callable):
    _ensure_builtin()
    if key in _REGISTRY:
        raise ValueError(f"duplicate env key: {key}")
    _REGISTRY[key] = factory
    for mk in [mk for mk in _ENV_MEMO if mk[0] == key]:
        del _ENV_MEMO[mk]


def describe(key: str | None = None):
    """Info string(s) for registered env families."""
    _ensure_builtin()
    if key is not None:
        family = key if key in _REGISTRY else parse_key(key)[0]
        return _INFO.get(family, "")
    return {k: _INFO.get(k, "") for k in sorted(_REGISTRY)}


def _factory(key: str):
    """(factory, parsed kwargs) for a registered family or full key."""
    factory = _REGISTRY.get(key)
    if factory is not None:
        return factory, {}
    family, parsed = parse_key(key)
    factory = _REGISTRY.get(family)
    if factory is None:
        if family in _NOT_PORTED:
            raise KeyError(
                f"env family '{family}' is not ported to cpr_tpu_torch yet "
                f"(ROADMAP item {_NOT_PORTED[family]}); use cpr_tpu for it")
        raise KeyError(f"unknown env '{key}'; choose from {sorted(_REGISTRY)}")
    return factory, parsed


def get(key: str, **kwargs):
    """Instantiate the env for `key` — either a registered family name
    with explicit kwargs, or a full protocol key parsed by `parse_key`.
    Identical (key, kwargs) return the SAME env object; do not mutate a
    returned env."""
    _ensure_builtin()
    try:
        memo_key = (key, tuple(sorted(kwargs.items())))
        hash(memo_key)
    except TypeError:
        memo_key = None
    if memo_key is not None and memo_key in _ENV_MEMO:
        return _ENV_MEMO[memo_key]
    factory, parsed = _factory(key)
    env = factory(**{**parsed, **kwargs})
    if memo_key is not None:
        _ENV_MEMO[memo_key] = env
    return env


def clear_memo():
    """Drop all memoized env instances."""
    _ENV_MEMO.clear()


def keys():
    _ensure_builtin()
    return sorted(_REGISTRY)


def get_sized(key: str, max_steps_hint: int, **kwargs):
    """get() with a capacity hint, dropped for envs that don't plan
    capacity (e.g. nakamoto's closed-form scalar state)."""
    _ensure_builtin()
    factory, _ = _factory(key)
    try:
        sig = inspect.signature(factory)
        takes_hint = "max_steps_hint" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values())
    except (TypeError, ValueError):
        takes_hint = True
    if takes_hint:
        return get(key, max_steps_hint=max_steps_hint, **kwargs)
    return get(key, **kwargs)


def parse_key(key: str):
    """Parse a reference-style protocol key (cpr_protocols.ml:786-903):

        nakamoto
        ethereum-whitepaper | ethereum-byzantium
        bk-<k>-<constant|block>
        spar-<k>-<constant|block>
        stree-<k>-<scheme>[-<selection>]
        sdag-<k>-<constant|discount>[-<selection>]
        tailstorm-<k>-<scheme>[-<selection>]

    Returns (family, kwargs)."""
    parts = key.split("-")
    family = parts[0]
    if family in ("nakamoto",) and len(parts) == 1:
        return family, {}
    if family == "ethereum":
        if len(parts) == 2 and parts[1] in ("whitepaper", "byzantium"):
            return family, {"preset": parts[1]}
        raise KeyError(f"cannot parse protocol key '{key}': expected "
                       "ethereum-<whitepaper|byzantium>")
    grammars = {
        # family: (schemes, selections or None, min k)
        "bk": (("constant", "block"), None, 1),
        "spar": (("constant", "block"), None, 1),
        "stree": (("constant", "discount", "punish", "hybrid"),
                  ("altruistic", "heuristic", "optimal"), 1),
        "sdag": (("constant", "discount"), ("altruistic", "heuristic"), 2),
        "tailstorm": (("constant", "discount", "punish", "hybrid"),
                      ("altruistic", "heuristic", "optimal"), 1),
        "tailstormjune": (("constant", "discount", "punish", "hybrid",
                           "block"), None, 1),
    }
    if family in grammars:
        schemes, selections, min_k = grammars[family]
        want_parts = 3 if selections is None else 4
        if len(parts) != want_parts or not parts[1].isdigit():
            raise KeyError(
                f"cannot parse protocol key '{key}': expected "
                f"{family}-<k>-<scheme>"
                + ("-<selection>" if selections else ""))
        kw = {"k": int(parts[1])}
        if kw["k"] < min_k:
            raise KeyError(f"cannot parse protocol key '{key}': "
                           f"{family} requires k >= {min_k}")
        if parts[2] not in schemes:
            raise KeyError(f"cannot parse protocol key '{key}': "
                           f"scheme must be one of {schemes}")
        kw["incentive_scheme"] = parts[2]
        if selections is not None:
            if parts[3] not in selections:
                raise KeyError(f"cannot parse protocol key '{key}': "
                               f"selection must be one of {selections}")
            kw["subblock_selection"] = parts[3]
        return family, kw
    raise KeyError(f"cannot parse protocol key '{key}'")


_BUILTIN_LOADED = False


def _ensure_builtin():
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    from cpr_tpu_torch.envs.bk import BkSSZ
    from cpr_tpu_torch.envs.ethereum import EthereumSSZ
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.envs.sdag import SdagSSZ
    from cpr_tpu_torch.envs.spar import SparSSZ
    from cpr_tpu_torch.envs.stree import StreeSSZ
    from cpr_tpu_torch.envs.tailstorm import TailstormSSZ
    from cpr_tpu_torch.envs.tailstorm_june import TailstormJuneSSZ

    _BUILTIN_LOADED = True
    for key, factory in [
        ("nakamoto", NakamotoSSZ),
        ("bk", BkSSZ),
        ("ethereum", EthereumSSZ),
        ("ethereum-whitepaper",
         lambda **kw: EthereumSSZ("whitepaper", **kw)),
        ("ethereum-byzantium",
         lambda **kw: EthereumSSZ("byzantium", **kw)),
        ("spar", SparSSZ),
        ("stree", StreeSSZ),
        ("sdag", SdagSSZ),
        ("tailstorm", TailstormSSZ),
        ("tailstormjune", TailstormJuneSSZ),
    ]:
        _REGISTRY.setdefault(key, factory)
