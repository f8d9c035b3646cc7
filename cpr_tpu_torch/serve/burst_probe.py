"""Where a serve burst's time goes at the server's defaults, on the card.

    python -m cpr_tpu_torch.serve.burst_probe [--lanes 32] [--reps 100]

A `ResidentEngine` at the server's defaults (Nakamoto, 32 lanes, burst
and max_steps 256, alpha 0.25, honest) times `burst_run` with every lane
admitted in the burst, as the server's flood drives it, and a batch
`rollout()` of the same lanes and steps (the serve smoke's baseline):
back to back, after a 2 ms and a 10 ms sleep, and after a 2 ms busy
spin, so that a host path gone cold between bursts shows apart from the
card. Then K14's launch alone, its device span by CUDA events against
its call's wall time. `nvidia-smi` samples the SM clock every 100 ms
throughout. Prints one JSON object of milliseconds (p50, p10, p90 of
each) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry
from cpr_tpu_torch.params import make_params
from cpr_tpu_torch.serve.engine import ResidentEngine

GAPS = (("back_to_back", 0.0, False), ("sleep_2ms", 0.002, False),
        ("spin_2ms", 0.002, True), ("sleep_10ms", 0.01, False))


def _spin(s: float):
    t = time.perf_counter()
    while time.perf_counter() - t < s:
        pass


def _quantiles(ms) -> dict:
    x = np.asarray(ms, dtype=float)
    return dict(p50=float(np.median(x)), p10=float(np.percentile(x, 10)),
                p90=float(np.percentile(x, 90)), n=len(x))


def _timed(fn, reps: int, gap: float, busy: bool) -> dict:
    """fn's wall ms over `reps` calls after 5 unrecorded ones, each call
    followed by `gap` s of sleep (or of a busy spin)."""
    out = []
    for i in range(reps + 5):
        t = time.perf_counter()
        fn()
        if i >= 5:
            out.append((time.perf_counter() - t) * 1e3)
        if gap:
            (_spin if busy else time.sleep)(gap)
    return _quantiles(out)


def probe(lanes: int = 32, reps: int = 100) -> dict:
    dev = torch.device("cuda")
    steps = 256
    env = registry.get_sized("nakamoto", steps)
    params = make_params(alpha=0.25, gamma=0.5, max_steps=steps)
    eng = ResidentEngine(env, params, n_lanes=lanes, burst=steps,
                         device=dev)
    eng.start()
    pid = eng.policy_ids["honest"]
    lane_policy = dict.fromkeys(range(lanes), pid)
    seed = [1000]

    def burst():
        admit = {ln: seed[0] + ln for ln in range(lanes)}
        seed[0] += lanes
        eng.burst_run(lane_policy, admit=admit)

    keys = rnd.split(rnd.PRNGKey(0, dev), lanes)
    honest = env.policies["honest"]

    def rollout():
        env.rollout(keys, params, honest, steps)
        torch.cuda.synchronize()

    out = {}
    for name, gap, busy in GAPS:
        out["burst_run_" + name] = _timed(burst, reps, gap, busy)
        out["rollout_" + name] = _timed(rollout, max(reps // 4, 5), gap,
                                        busy)
    # K14's launch alone (its inputs staged in place: every lane live)
    all_lanes = np.arange(lanes)
    eng._burst_staged(all_lanes, np.full(lanes, pid, np.int32), {pid})
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    for name, gap in (("back_to_back", 0.0), ("sleep_2ms", 0.002)):
        span, call = [], []
        for _ in range(reps):
            ev0.record()
            t = time.perf_counter()
            eng._launch()
            call.append((time.perf_counter() - t) * 1e3)
            ev1.record()
            ev1.synchronize()
            span.append(ev0.elapsed_time(ev1))
            if gap:
                time.sleep(gap)
        out["launch_device_" + name] = _quantiles(span)
        out["launch_call_" + name] = _quantiles(call)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("burst_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        out = probe(args.lanes, args.reps)
    finally:
        smi.terminate()
        clocks = [int(x) for x in smi.communicate()[0].split()
                  if x.isdigit()]
    if clocks:
        out["sm_clock_mhz"] = dict(min=min(clocks), max=max(clocks),
                                   n=len(clocks))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
