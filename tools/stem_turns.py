"""Config D's stem, (C1, C2) = (64, 128), of two source trees in turns on one
NVIDIA card.

    python3 tools/stem_turns.py PARENT_DIR CHANGE_DIR

Each directory is a checkout of this repository (for example a commit's
``git archive`` unpacked into a directory that ``.gitignore`` lists). In
the order parent, change, change, parent, a subprocess imports that tree's
``nanovs_slam_torch`` (whose kernels build from its own ``csrc/``) and
``chip_smoke.py`` and measures, on 240x320 frames:

- the stem kernel at float32 and bf16, batch 1 and 8: ``chip_smoke``'s
  D cases (``kernel_cases``: the same seeded inputs and checks against
  ``stem_plain``), timed by ``chip_smoke.cuda_ms`` (CUDA events behind a
  spin kernel, median of 15);
- one request of config D (V2, 28 classes, seeded weights and BN
  statistics) through ``make_infer_fn`` at float32 and bf16, batch 1 and
  8: the host-clock median ms of 20 steady requests and the device ms of
  a request (``chip_smoke.busy_share``, torch.profiler).

Prints the card's name and power limit, one JSON line a turn, and the
medians of each tree's two turns. It imports neither jax nor
nanovs_slam_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.inference import make_infer_fn
from nanovs_slam_torch.models.kp2dtiny import build_model, init_model

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
out = {}
for B in (1, 8):
    for c in cs.kernel_cases(B, dev):
        if (c.entry, c.suffix) not in ((cs.STEM_D, ""), (cs.STEM_D, "_b8"),
                                       (cs.STEM_BF16, "_d"),
                                       (cs.STEM_BF16, "_d_b8")):
            continue
        got, want = c.run(), c.plain()
        torch.cuda.synchronize()
        c.check(got, want)
        dt = "bf16" if c.entry == cs.STEM_BF16 else "float32"
        out[f"kernel_{dt}_B{B}"] = cs.cuda_ms(c.run)
gen = torch.Generator().manual_seed(cs.SEED + 1300)
cfg32 = get_config("D", n_classes=28)
cfg16 = get_config("D", n_classes=28, dtype="bfloat16")
model32 = init_model(cfg32, gen, "cpu")
cs.randomize_bn(model32, gen)
model16 = build_model(cfg16).eval()
model16.load_state_dict(model32.state_dict())
rs = np.random.RandomState(cs.SEED + 1300)
for B in (1, 8):
    frames = rs.randint(0, 256, (B, cs.H, cs.W, 3)).astype(np.uint8)
    for dt, model, cfg in (("float32", model32, cfg32),
                           ("bf16", model16, cfg16)):
        infer = make_infer_fn(model, cfg, cs.H, cs.W, device=dev,
                              top_k=1000, conf_threshold=0.7)
        times = []
        for _ in range(25):
            t0 = time.perf_counter()
            infer(frames)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        dev_ms, busy = cs.busy_share(lambda: infer(frames))
        out[f"request_{dt}_B{B}"] = statistics.median(times[5:])
        out[f"request_device_{dt}_B{B}"] = dev_ms
print(json.dumps(out))
"""


def turn(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    r = subprocess.run([sys.executable, "-c", CHILD, tree], env=env,
                       cwd=tree, capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{tree}: rc {r.returncode}\n{r.stdout[-4000:]}\n"
                         f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(argv[0]),
             "change": os.path.abspath(argv[1])}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        res = turn(trees[name])
        runs[name].append(res)
        print(json.dumps({"turn": name, **res}), flush=True)
    summary = {name: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0]} for name, rs in runs.items()}
    print(json.dumps({"medians": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
