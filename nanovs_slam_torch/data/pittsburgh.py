"""Pittsburgh 30k/250k VPR dataset (NetVLAD .mat dbStruct format) for the
retrieval evaluation, the counterpart of ``nanovs_slam_tpu/data/
pittsburgh.py``: ``parse_db_struct`` is a copy (scipy reads the .mat);
``WholeDataset`` is one, with cv2 imported where images are read, and its
positives found by ``scipy.spatial.cKDTree.query_ball_point`` in place of
sklearn's ``NearestNeighbors.radius_neighbors`` (the card's machine has no
sklearn). Both keep the database entries within ``posDistThr`` of a query,
the radius included; the metrics read only which entries and how many, so
their order does not matter (here they are sorted).
``TripletMiningDataset`` waits with ``train_visloc`` (ROADMAP Queue 1
item 4).
"""

from __future__ import annotations

import os
from collections import namedtuple
from typing import List, Optional, Tuple

import numpy as np

DbStruct = namedtuple(
    "DbStruct",
    ["whichSet", "dataset", "dbImage", "utmDb", "qImage", "utmQ", "numDb",
     "numQ", "posDistThr", "posDistSqThr", "nonTrivPosDistSqThr"])


def _cell_to_str(f) -> str:
    """Unwrap a loadmat cell entry to a plain string (handles varying
    nesting between real NetVLAD mats and savemat round-trips)."""
    v = f
    while not isinstance(v, str):
        if hasattr(v, "item") and getattr(v, "size", 2) == 1:
            v = v.item()
        else:
            v = v[0]
    return v


def parse_db_struct(path: str) -> DbStruct:
    from scipy.io import loadmat

    mat = loadmat(path)
    m = mat["dbStruct"].item()
    dataset = "pitts"
    which_set = _cell_to_str(m[0])
    db_image = [_cell_to_str(f) for f in m[1]]
    utm_db = m[2].T
    q_image = [_cell_to_str(f) for f in m[3]]
    utm_q = m[4].T
    num_db = int(m[5].item())
    num_q = int(m[6].item())
    pos_dist_thr = m[7].item()
    pos_dist_sq_thr = m[8].item()
    non_triv_pos_dist_sq_thr = m[9].item()
    return DbStruct(which_set, dataset, db_image, utm_db, q_image, utm_q,
                    num_db, num_q, pos_dist_thr, pos_dist_sq_thr,
                    non_triv_pos_dist_sq_thr)


def radius_positives(utm_db: np.ndarray, utm_q: np.ndarray,
                     radius: float) -> List[np.ndarray]:
    """For each query, the (sorted) database indices within ``radius``,
    the radius included."""
    from scipy.spatial import cKDTree

    hits = cKDTree(utm_db).query_ball_point(utm_q, r=radius)
    return [np.asarray(sorted(h), np.int64) for h in hits]


class WholeDataset:
    """db + query images in one indexable set; get_positives() gives the
    UTM-radius ground truth used by evaluate_global_descriptor."""

    def __init__(self, struct_path: str, img_root: str,
                 size: Tuple[int, int]):
        self.dbStruct = parse_db_struct(struct_path)
        self.img_root = img_root
        self.size = size
        self.images = ([os.path.join(img_root, im)
                        for im in self.dbStruct.dbImage]
                       + [os.path.join(img_root, "queries_real", im)
                          for im in self.dbStruct.qImage])
        self._positives: Optional[List[np.ndarray]] = None

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> np.ndarray:
        import cv2

        img = cv2.cvtColor(cv2.imread(self.images[i]), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (self.size[1], self.size[0]))
        return (img.astype(np.float32) / 255.0) * 2.0 - 1.0

    def get_positives(self) -> List[np.ndarray]:
        if self._positives is None:
            self._positives = radius_positives(
                self.dbStruct.utmDb, self.dbStruct.utmQ,
                self.dbStruct.posDistThr)
        return self._positives
