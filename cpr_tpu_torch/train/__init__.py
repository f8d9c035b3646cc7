"""RL training (port of cpr_tpu/train/): PPO over the port's lane-batched
envs (`ppo`), its optimizer (`optim`), the YAML config model (`config`),
the config-driven driver with per-alpha eval and checkpoints (`driver`),
and flax's msgpack params format (`serialization`). On the card a
train_step runs the stream kernels with the policy net inside and the
K11 kernels for GAE, the loss head and Adam."""
