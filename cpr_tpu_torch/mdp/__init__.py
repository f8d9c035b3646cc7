"""MDP attack-search toolbox of the port.

Reference counterpart: `cpr_tpu/mdp/`. The implicit model interface,
the exhaustive BFS compiler, the explicit `MDP` table and the
literature models are host code, copied; `TensorMDP` solves a compiled
table with value iteration and policy evaluation on the card through
the hand-written CUDA kernels K4 and K5, or on the CPU through their
plain torch twins. The native generic compiler is
`cpr_tpu_torch.mdp.generic.compile_native`.
"""

from cpr_tpu_torch.mdp.implicit import Effect, Model, PTOWrapper, Transition  # noqa: F401
from cpr_tpu_torch.mdp.compiler import Compiler  # noqa: F401
from cpr_tpu_torch.mdp.explicit import (  # noqa: F401
    MDP,
    PaddedLayoutTooLarge,
    TensorMDP,
    ptmdp,
)
