"""The device RANSAC of two source trees in turns on one NVIDIA card, at
one pair a call (the path of the online VO and of the offline pose map at
pair_batch 1).

    python3 tools/pose_turns.py PARENT_DIR CHANGE_DIR

Each directory is a checkout of this repository (for example a commit's
``git archive`` unpacked into a directory that ``.gitignore`` lists). In
the order parent, change, change, parent, a subprocess imports that
tree's ``nanovs_slam_torch`` and times, on seeded synthetic scenes (KITTI's
camera at 376x1241, 3D points 5-50 m ahead, a 2 degree yaw and 1 m
forward, 0.5 px noise, 30% of the matches replaced by random pixels):

- ``ransac_essential_device`` on one pair (700 matches in 1024 slots,
  float64, 8192 hypotheses, 3 restarts): host-clock ms of a call;
- ``OfflineVO.pose_map`` at its default pair_batch on 7 such pairs (600-
  900 matches each): host-clock ms a pair;
- ``VisualOdometry._estimate_pose_on_device`` (the online VO's pose stage
  a frame, pixel matches in, its host undistortion included): host-clock
  ms a call.

Every time is the median of the steady calls, each ending in a
synchronise. Prints the card's name and power limit, one JSON line a turn
(with the first pair's R and t, so that the trees' answers can be held
against each other), the medians of each tree's two turns and the largest
gap of R and t between the trees. It imports neither jax nor
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
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import init_model
from nanovs_slam_torch.vo.camera import PinholeCamera, kitti_params
from nanovs_slam_torch.vo.offline import OfflineVO
from nanovs_slam_torch.vo.pose import ransac_essential_device
from nanovs_slam_torch.vo.visual_odometry import VisualOdometry

dev = torch.device("cuda")
H, W, SLOTS = 376, 1241, 1024
fx, fy, cx, cy = kitti_params()
cam = PinholeCamera(W, H, fx, fy, cx, cy)


def scene(seed, n):
    # (pixel matches ref (n, 2), cur (n, 2)) of a seeded scene
    rs = np.random.RandomState(seed)
    X = np.stack([rs.uniform(-20, 20, 4 * n), rs.uniform(-5, 5, 4 * n),
                  rs.uniform(5, 50, 4 * n)], 1)
    a = np.deg2rad(2.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    Y = X @ R.T - np.array([0.0, 0.0, 1.0])

    def px(P):
        return np.stack([fx * P[:, 0] / P[:, 2] + cx,
                         fy * P[:, 1] / P[:, 2] + cy], 1)

    p0, p1 = px(X), px(Y)
    ok = ((p0 >= 0) & (p0 < [W, H]) & (p1 >= 0) & (p1 < [W, H])).all(1)
    ok &= Y[:, 2] > 1.0
    p0, p1 = p0[ok][:n], p1[ok][:n]
    p1 = p1 + rs.randn(*p1.shape) * 0.5
    out = rs.rand(len(p1)) < 0.3
    p1[out] = rs.uniform(0, 1, (out.sum(), 2)) * [W, H]
    return p0, p1


def normalised(p0, p1):
    a = np.zeros((SLOTS, 2))
    b = np.zeros((SLOTS, 2))
    a[:len(p0)] = (p0 - [cx, cy]) / [fx, fy]
    b[:len(p1)] = (p1 - [cx, cy]) / [fx, fy]
    return a, b, np.arange(SLOTS) < len(p0)


def host_ms(fn, n, warm=3):
    times = []
    for i in range(warm + n):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[warm:])


out = {}
a, b, v = normalised(*scene(0, 700))
ta, tb, tv = (torch.from_numpy(x).to(dev) for x in (a, b, v))


def one(i):
    return ransac_essential_device(
        ta, tb, torch.Generator(device=dev).manual_seed(i), valid=tv,
        n_hypotheses=8192, restarts=3)


R, t, inl = one(0)
out["R"] = R.cpu().numpy().ravel().tolist()
out["t"] = t.cpu().numpy().ravel().tolist()
out["inliers"] = int(inl.sum())
out["ransac_ms_a_call"] = host_ms(one, 15)

pairs = [normalised(*scene(10 + i, 600 + 50 * i)) for i in range(7)]
kpn0, kpn1, valid = (torch.from_numpy(np.stack(x)).to(dev)
                     for x in zip(*pairs))
cfg = get_config("S", n_classes=8)
model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
vo = OfflineVO(model, cfg, (128, 512), cam, matcher="bf", device=dev)
Rm, tm, ninl, nmat = vo.pose_map(kpn0, kpn1, valid, seed=0)
out["pose_map_R"] = Rm.cpu().numpy().ravel().tolist()
out["pose_map_inliers"] = ninl.cpu().numpy().tolist()
out["pose_map_ms_a_pair"] = host_ms(
    lambda i: vo.pose_map(kpn0, kpn1, valid, seed=i), 5, warm=1) / 7

online = VisualOdometry(None, cam, device_pose=True, device=dev)
m0, m1 = scene(1, 700)
out["online_pose_ms_a_frame"] = host_ms(
    lambda i: online._estimate_pose_on_device(m0, m1), 15)
print(json.dumps(out))
"""

TIMES = ("ransac_ms_a_call", "pose_map_ms_a_pair", "online_pose_ms_a_frame")


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
    summary = {name: {k: statistics.median(r[k] for r in rs) for k in TIMES}
               for name, rs in runs.items()}
    p, c = runs["parent"][0], runs["change"][0]
    gap = max(abs(x - y) for k in ("R", "t", "pose_map_R")
              for x, y in zip(p[k], c[k]))
    same = (p["inliers"] == c["inliers"]
            and p["pose_map_inliers"] == c["pose_map_inliers"])
    print(json.dumps({"medians": summary, "R_t_gap": gap,
                      "inlier_counts_equal": same, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
