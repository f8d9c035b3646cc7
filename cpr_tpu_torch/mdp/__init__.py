"""MDP attack-search toolbox of the port.

Reference counterpart: `cpr_tpu/mdp/`. The implicit model interface,
the BFS compilers (serial and frontier-batched), the explicit `MDP`
table, the literature models, host RTDP and the policy-guided explorer
are host code, copied; `TensorMDP` solves a compiled table with value
iteration and policy evaluation (CUDA kernels K4, K5) and device RTDP
(K6) on the card, or on the CPU through their plain torch twins.
`mdp.grid` compiles parametrically and solves alpha x gamma grids (K7).
The native generic compiler is `cpr_tpu_torch.mdp.generic.compile_native`.
"""

from cpr_tpu_torch.mdp.implicit import Effect, Model, PTOWrapper, Transition  # noqa: F401
from cpr_tpu_torch.mdp.compiler import Compiler  # noqa: F401
from cpr_tpu_torch.mdp.explorer import Explorer  # noqa: F401
from cpr_tpu_torch.mdp.frontier import FrontierCompiler  # noqa: F401
from cpr_tpu_torch.mdp.rtdp import RTDP  # noqa: F401
from cpr_tpu_torch.mdp.explicit import (  # noqa: F401
    MDP,
    PaddedLayoutTooLarge,
    TensorMDP,
    ptmdp,
)
from cpr_tpu_torch.mdp.grid import (  # noqa: F401
    Param,
    ParamError,
    ParamMDP,
    check_revalue_parity,
    compile_protocol,
    grid_value_iteration,
    param_pair,
    param_ptmdp,
    parametric_compile,
    parametric_compile_native,
    solve_grid_cached,
)
from cpr_tpu_torch.mdp.rtdp_graph import (  # noqa: F401
    rtdp_graph,
    rtdp_sharded_polish,
)
