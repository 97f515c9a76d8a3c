"""MovieLens-1M ratings helpers (a copy of
``bigdl_tpu/dataset/movielens.py``: the same ``ratings.dat`` parse and
``synthetic_movielens`` rows for the same seed).

≙ ref: pyspark/bigdl/dataset/movielens.py:1 (read_data_sets /
get_id_pairs / get_id_ratings over ml-1m's ``ratings.dat``). Same return
shapes; ``synthetic_movielens`` generates latent-factor-structured ratings
offline.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

SOURCE_URL = "http://files.grouplens.org/datasets/movielens/"


def read_data_sets(data_dir: str) -> np.ndarray:
    """(N, 4) int array [user, item, rating, timestamp] from ml-1m,
    downloading the zip if absent (≙ ref read_data_sets)."""
    extracted_to = os.path.join(data_dir, "ml-1m")
    rating_file = os.path.join(extracted_to, "ratings.dat")
    if not os.path.exists(rating_file):
        from bigdl_tpu_torch.dataset.news20 import _maybe_download

        local_file = _maybe_download("ml-1m.zip", data_dir,
                                     SOURCE_URL + "ml-1m.zip")
        print(f"Extracting {local_file} to {data_dir}")
        with zipfile.ZipFile(local_file, "r") as zf:
            zf.extractall(data_dir)
    with open(rating_file) as f:
        rows = [line.strip().split("::") for line in f if line.strip()]
    return np.asarray(rows).astype(int)


def get_id_pairs(data_dir: str) -> np.ndarray:
    """(N, 2) [user, item]."""
    return read_data_sets(data_dir)[:, 0:2]


def get_id_ratings(data_dir: str) -> np.ndarray:
    """(N, 3) [user, item, rating]."""
    return read_data_sets(data_dir)[:, 0:3]


def synthetic_movielens(n_users: int = 100, n_items: int = 200,
                        n_ratings: int = 5000, seed: int = 0) -> np.ndarray:
    """Offline stand-in for read_data_sets: (N, 4) ratings drawn from a
    rank-4 user x item latent model (so factorization models can actually
    fit it), ids 1-based like ml-1m."""
    rng = np.random.RandomState(seed)
    u_f = rng.randn(n_users, 4)
    i_f = rng.randn(n_items, 4)
    users = rng.randint(1, n_users + 1, n_ratings)
    items = rng.randint(1, n_items + 1, n_ratings)
    scores = np.einsum("nf,nf->n", u_f[users - 1], i_f[items - 1])
    # squash latent affinity to the 1..5 star scale
    ratings = np.clip(np.round(3.0 + scores), 1, 5).astype(int)
    ts = rng.randint(0, 10_000_000, n_ratings)
    return np.stack([users, items, ratings, ts], axis=1)
