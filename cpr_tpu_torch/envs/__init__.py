"""Attack environments over torch tensors (port of cpr_tpu.envs); the
gymnasium adapters and registered env ids live in cpr_tpu_torch.gym."""

from cpr_tpu_torch.envs.registry import get, keys, register  # noqa: F401
