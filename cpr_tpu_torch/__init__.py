"""PyTorch/CUDA port of cpr_tpu.

The environments, PRNG and gym surface of `cpr_tpu` re-written over
torch tensors, with the hot device programs as hand-written CUDA
kernels for Hopper (`cpr_tpu_torch/csrc/`, built at first use by
`cpr_tpu_torch.kernels`). Each kernel has a plain PyTorch twin that
runs where a tensor lies on the CPU; a CUDA tensor always goes to the
kernel.

Importing this package needs torch and numpy only: no jax, flax or
gymnasium (the gym adapters in `cpr_tpu_torch.gym` import gymnasium).
"""

from cpr_tpu_torch.params import (  # noqa: F401
    EnvParams, ParameterError, make_params, stack_params)

__version__ = "0.1.0"
