"""The multi-node network simulator on the card (port of
cpr_tpu/netsim).

A `network.Network` compiles into dense planes (`compile_network`); the
honest-node engine (`Engine`: the scan path K12-scan, and the event
engine, K12-event for Nakamoto and K12-event-bk/-eth/-spar for Bk,
Ethereum and Spar) and the attacker at node 0 (`AttackEngine`, K13) run
a batch of independent lanes, each a (seed, activation delay[, alpha,
policy]) tuple, as one kernel launch. Semantics, RNG stream and outputs
are the JAX package's, for every protocol it supports.
"""

from cpr_tpu_torch.netsim.compile import (  # noqa: F401
    NETSIM_KINDS, CompiledNet, compile_network, sample_delay_matrix,
)
from cpr_tpu_torch.netsim.engine import (  # noqa: F401
    SUPPORTED_PROTOCOLS, Engine, grid, supports,
)
from cpr_tpu_torch.netsim.attack import (  # noqa: F401
    ATTACK_PROTOCOLS, DEFAULT_ATTACK_POLICIES, AttackEngine,
    attack_supports, attack_sweep, attack_sweep_cached,
)

__all__ = ["CompiledNet", "compile_network", "sample_delay_matrix",
           "NETSIM_KINDS", "Engine", "SUPPORTED_PROTOCOLS", "grid",
           "supports", "ATTACK_PROTOCOLS", "AttackEngine",
           "DEFAULT_ATTACK_POLICIES", "attack_supports", "attack_sweep",
           "attack_sweep_cached"]
