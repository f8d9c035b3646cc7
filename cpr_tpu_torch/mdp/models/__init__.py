"""Literature and generic protocol MDP models.

Reference counterpart: mdp/lib/models/ (fc16sapirshtein, aft20barzur,
generic_v0, generic_v1).
"""

from cpr_tpu_torch.mdp.models.bitcoin_sm import (  # noqa: F401
    Aft20BitcoinSM,
    Fc16BitcoinSM,
    map_params,
    mappable_params,
)
