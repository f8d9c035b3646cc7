"""The sampler-side key stream (port of cpr_tpu/learn/buffer.py:35-49).

Only `EXPERIENCE_STREAM` and `experience_stream`, which `train.ppo`
re-exports; the per-lane experience rings (K15) are ROADMAP item 12.
"""

from __future__ import annotations

import torch

from cpr_tpu_torch import random

# the fold_in stream tag separating sampler-side keys from every other
# consumer of a lane key ("EXP")
EXPERIENCE_STREAM = 0x455850


def experience_stream(key: torch.Tensor) -> torch.Tensor:
    """The sampler-side stream of a lane key: fold_in with the stream
    tag, never `split`, so it cannot collide with the key the lane
    spends on env dynamics."""
    return random.fold_in(key, EXPERIENCE_STREAM)
