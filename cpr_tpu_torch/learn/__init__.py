"""Experience plumbing of the sampler/learner loop (port of
cpr_tpu/learn/): so far only the key-stream tag that `train.ppo` shares
with it. The rings, the recorder and the learner are ROADMAP item 12."""
