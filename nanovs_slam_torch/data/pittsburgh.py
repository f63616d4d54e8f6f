"""Pittsburgh 30k/250k VPR dataset (NetVLAD .mat dbStruct format) for the
retrieval evaluation, the counterpart of ``nanovs_slam_tpu/data/
pittsburgh.py``: ``parse_db_struct`` is a copy (scipy reads the .mat);
``WholeDataset`` is one, with cv2 imported where images are read, and its
positives found by ``scipy.spatial.cKDTree.query_ball_point`` in place of
sklearn's ``NearestNeighbors.radius_neighbors`` (the card's machine has no
sklearn). Both keep the database entries within ``posDistThr`` of a query,
the radius included; the metrics read only which entries and how many, so
their order does not matter (here they are sorted).
``TripletMiningDataset`` (for ``train_visloc``) mines hard negatives
against a descriptor cache as the JAX class does, its radius searches by
``radius_positives``: the JAX class sorts its non-trivial positives by
index and takes its potential negatives by ``np.setdiff1d``, so the sets
and their order are the same, and so are its ``RandomState`` draws.
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
        return _load_image(self.images[i], self.size)

    def get_positives(self) -> List[np.ndarray]:
        if self._positives is None:
            self._positives = radius_positives(
                self.dbStruct.utmDb, self.dbStruct.utmQ,
                self.dbStruct.posDistThr)
        return self._positives


def _load_image(path: str, size: Tuple[int, int]) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [-1, 1] at ``size`` (cv2)."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    img = cv2.resize(img, (size[1], size[0]))
    return (img.astype(np.float32) / 255.0) * 2.0 - 1.0


class TripletMiningDataset:
    """Hard-negative mining against a descriptor cache
    (QueryDatasetFromStruct, reference pittsburgh.py:234-354): a query's
    best non-trivial positive, and up to ``n_neg`` negatives closer than
    that positive plus sqrt(``margin``), from ``n_neg_sample`` sampled
    potential negatives and the query's ``neg_cache``."""

    def __init__(self, struct_path: str, img_root: str,
                 size: Tuple[int, int], n_neg_sample: int = 1000,
                 n_neg: int = 10, margin: float = 0.1, seed: int = 0):
        self.dbStruct = parse_db_struct(struct_path)
        self.img_root = img_root
        self.size = size
        self.n_neg_sample = n_neg_sample
        self.n_neg = n_neg
        self.margin = margin
        self.rng = np.random.RandomState(seed)

        db = self.dbStruct
        # non-trivial positives, and everything outside posDistThr as the
        # potential negatives
        self.nontrivial_positives = radius_positives(
            db.utmDb, db.utmQ, float(np.sqrt(db.nonTrivPosDistSqThr)))
        potential_pos = radius_positives(db.utmDb, db.utmQ, db.posDistThr)
        self.potential_negatives = [
            np.setdiff1d(np.arange(db.numDb), p, assume_unique=True)
            for p in potential_pos]
        self.neg_cache = [np.empty((0,), np.int64) for _ in range(db.numQ)]
        self.queries = [i for i in range(db.numQ)
                        if len(self.nontrivial_positives[i]) > 0]
        self.cache: Optional[np.ndarray] = None  # (numDb + numQ, D)

    def __len__(self):
        return len(self.queries)

    def mine(self, index: int):
        """(q_img, pos_img, neg_imgs (<= n_neg, ...)) in [-1, 1] of the
        ``index``-th query, or None if no negative violates the margin;
        updates the query's ``neg_cache``."""
        if self.cache is None:
            raise ValueError("set .cache to the descriptor cache first")
        db = self.dbStruct
        q = self.queries[index]
        q_feat = self.cache[db.numDb + q]

        pos_ids = self.nontrivial_positives[q]
        d_pos = np.linalg.norm(self.cache[pos_ids] - q_feat, axis=1)
        best = np.argmin(d_pos)
        pos_idx = pos_ids[best]

        negs = self.potential_negatives[q]
        neg_sample = self.rng.choice(negs, min(self.n_neg_sample, len(negs)),
                                     replace=False)
        neg_sample = np.unique(np.concatenate([self.neg_cache[q],
                                               neg_sample]))
        d_neg = np.linalg.norm(self.cache[neg_sample] - q_feat, axis=1)
        # violating: closer than the best positive plus the margin
        violating = d_neg < d_pos[best] + self.margin ** 0.5
        if violating.sum() < 1:
            return None
        order = np.argsort(d_neg)
        neg_ids = neg_sample[order[violating[order]][: self.n_neg * 10]
                             ][: self.n_neg]
        self.neg_cache[q] = neg_ids

        q_img = _load_image(os.path.join(self.img_root, "queries_real",
                                         db.qImage[q]), self.size)
        pos_img = _load_image(os.path.join(self.img_root,
                                           db.dbImage[pos_idx]), self.size)
        neg_imgs = np.stack([
            _load_image(os.path.join(self.img_root, db.dbImage[n]),
                        self.size) for n in neg_ids])
        return q_img, pos_img, neg_imgs
