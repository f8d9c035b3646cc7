"""The kernels' build cost and the 64-node honest-net sweep, this tree
against another, on the card.

    python -m cpr_tpu_torch.kernels.build_cost OTHER_ROOT [--out DIR]

OTHER_ROOT is the root of another checkout (it holds `cpr_tpu_torch/`,
e.g. a parent commit unpacked with `git archive`). Each tree's kernels
are built from an empty build directory under DIR, one tree after the
other, by a child process; each build prints its wall seconds and the
CPU seconds (user + system) of its nvcc processes. Then a child of each
tree, in the order other, this, this, other, times three calls of
`honest_net_rows(engine="jax", n_nodes=64)` (the netsim kernels alone
loaded) and prints them with the scan's launch counter.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]

BUILD = """
import resource, sys, time
from cpr_tpu_torch import kernels
t0 = time.time()
kernels.build()
ru = resource.getrusage(resource.RUSAGE_CHILDREN)
print(f"[build_cost] root={sys.argv[1]} sources={len(kernels.SOURCES)} "
      f"wall_s={time.time() - t0:.1f} "
      f"nvcc_cpu_s={ru.ru_utime + ru.ru_stime:.1f}", flush=True)
"""

SWEEP = """
import sys, time
import torch
from cpr_tpu_torch import kernels
paths = kernels.build()
kernels._libs["random"] = kernels._random_lib(paths["random.cu"])
kernels._libs.update(kernels._load_netsim(paths))
kernels._loaded.set()
from cpr_tpu_torch.experiments import honest_net_rows
secs = []
for _ in range(3):
    kernels.reset_launches()
    t0 = time.perf_counter()
    honest_net_rows(engine="jax", n_nodes=64)
    torch.cuda.synchronize()
    secs.append(round(time.perf_counter() - t0, 4))
scan = {k: v for k, v in kernels.launches.items() if v and "scan" in k}
print(f"[sweep_64] root={sys.argv[1]} call_s={secs} scan={scan}",
      flush=True)
"""


def child(code: str, root: Path, build: Path) -> None:
    env = {**os.environ, "PYTHONPATH": str(root),
           "CPR_TORCH_BUILD_DIR": str(build)}
    subprocess.run([sys.executable, "-c", code, str(root)], env=env,
                   cwd=root, check=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=HERE / "build" / "cost")
    a = ap.parse_args()
    trees = {"other": a.other.resolve(), "this": HERE}
    builds = {k: a.out / k for k in trees}
    for k in trees:
        shutil.rmtree(builds[k], ignore_errors=True)
        child(BUILD, trees[k], builds[k])
    for k in ("other", "this", "this", "other"):
        child(SWEEP, trees[k], builds[k])
    return 0


if __name__ == "__main__":
    sys.exit(main())
