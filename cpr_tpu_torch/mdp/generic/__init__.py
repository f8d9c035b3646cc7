"""Generic DAG-protocol attack models, compiled natively.

The C++ BFS compiler of the generic single-agent Release/Consider/
Continue model (`compile_native`) for bitcoin, ghostdag, parallel,
ethereum and byzantium. The Python `SingleAgent` model of the JAX
package, its DAG views, canonical labelling and protocol specs, is not
ported yet (ROADMAP item 7c).
"""

from cpr_tpu_torch.mdp.generic.native import compile_native

__all__ = ["compile_native"]
