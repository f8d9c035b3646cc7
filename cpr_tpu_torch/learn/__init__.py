"""Always-on learning over the serve lanes (port of cpr_tpu/learn/).

The resident serve lanes double as the sampler: they record transitions
into per-lane rings inside the burst (`buffer`, K15 inside K14 on the
card); a feeder thread ships consolidated windows over the serve wire
protocol to a separate learner process (`feed`); the learner runs the
PPO update phase on the fed experience (`train.ppo.
make_experience_update`, K11 on the card) and publishes sealed
snapshots (`learner`); and the server hot-swaps the serving weights at
the next burst boundary without draining a session
(`serve.engine.ResidentEngine.swap_policy`).

Every leg of the loop travels as one typed telemetry event family,
`learn`; `learn_event` is its only emitter.
"""

from __future__ import annotations

from cpr_tpu_torch import telemetry

# the five roles of the learning loop, in causal order
ROLES = ("sample", "feed", "update", "publish", "swap")


def learn_event(role: str, *, steps=None, batches=None,
                fingerprint=None, staleness_s=None, **extra):
    """Emit one typed `learn` event.

    role         -- one of ROLES.
    steps        -- env steps this leg moved (None when not step-shaped).
    batches      -- consolidated windows/batches this leg moved.
    fingerprint  -- snapshot payload_sha256 the leg acted under/on
                    (None before the first publish).
    staleness_s  -- age of the serving weights at this leg, None where
                    the emitting process cannot know it.
    """
    telemetry.current().event("learn", role=role, steps=steps,
                              batches=batches, fingerprint=fingerprint,
                              staleness_s=staleness_s, **extra)
