"""20 Newsgroups corpus + GloVe embedding helpers (a copy of
``bigdl_tpu/dataset/news20.py``: the same parse of an extracted tree, the
same offline error, and ``synthetic_news20``'s bytes for the same seed).

≙ ref: pyspark/bigdl/dataset/news20.py:1 (download_news20 / get_news20 /
get_glove_w2v feeding the textclassification example). Same on-disk layout
and return shapes; additionally ships ``synthetic_news20`` — a
keyword-separable corpus with the identical ``[(text, label)]`` shape — so
the example and tests can run the full text pipeline on machines with no
network access.
"""

from __future__ import annotations

import os
import tarfile
import zipfile
from typing import Dict, List, Tuple

import numpy as np

NEWS20_URL = "http://qwone.com/~jason/20Newsgroups/20news-18828.tar.gz"
GLOVE_URL = "http://nlp.stanford.edu/data/glove.6B.zip"

CLASS_NUM = 20


def _maybe_download(file_name: str, dest_dir: str, url: str) -> str:
    """Download ``url`` into ``dest_dir`` unless already present
    (≙ bigdl/dataset/base.maybe_download)."""
    os.makedirs(dest_dir, exist_ok=True)
    path = os.path.join(dest_dir, file_name)
    if os.path.exists(path):
        return path
    import urllib.request

    try:
        print(f"Downloading {url} -> {path}")
        urllib.request.urlretrieve(url, path)  # noqa: S310
    except Exception as e:
        raise RuntimeError(
            f"could not download {url} ({e}); place {file_name} in "
            f"{dest_dir} manually, or use synthetic_news20() for an "
            "offline corpus with the same shape") from e
    return path


def download_news20(dest_dir: str) -> str:
    extracted_to = os.path.join(dest_dir, "20news-18828")
    if os.path.exists(extracted_to):
        return extracted_to
    file_abs_path = _maybe_download("20news-18828.tar.gz", dest_dir,
                                    NEWS20_URL)
    print(f"Extracting {file_abs_path} to {extracted_to}")
    with tarfile.open(file_abs_path, "r:gz") as tar:
        tar.extractall(dest_dir)
    return extracted_to


def get_news20(source_dir: str = "./data/news20/") -> List[Tuple[str, int]]:
    """[(document text, 1-based label)] from the 20news-18828 tree,
    downloading it first if absent (≙ ref get_news20)."""
    news_dir = download_news20(source_dir)
    texts = []
    label_id = 0
    for name in sorted(os.listdir(news_dir)):
        path = os.path.join(news_dir, name)
        if os.path.isdir(path):  # stray files must not shift class ids
            label_id += 1
            for fname in sorted(os.listdir(path)):
                if fname.isdigit():
                    with open(os.path.join(path, fname),
                              encoding="latin-1") as f:
                        texts.append((f.read(), label_id))
    print(f"Found {len(texts)} texts.")
    return texts


def download_glove_w2v(dest_dir: str) -> str:
    extracted_to = os.path.join(dest_dir, "glove.6B")
    if os.path.exists(extracted_to):
        return extracted_to
    file_abs_path = _maybe_download("glove.6B.zip", dest_dir, GLOVE_URL)
    print(f"Extracting {file_abs_path} to {extracted_to}")
    with zipfile.ZipFile(file_abs_path, "r") as zf:
        zf.extractall(extracted_to)
    return extracted_to


def get_glove_w2v(source_dir: str = "./data/news20/",
                  dim: int = 100) -> Dict[str, List[float]]:
    """word -> vector dict from glove.6B.<dim>d.txt (≙ ref get_glove_w2v)."""
    w2v_dir = download_glove_w2v(source_dir)
    w2v = {}
    with open(os.path.join(w2v_dir, f"glove.6B.{dim}d.txt"),
              encoding="latin-1") as f:
        for line in f:
            items = line.rstrip().split(" ")
            w2v[items[0]] = [float(v) for v in items[1:]]
    return w2v


# --------------------------------------------------------------- offline
_TOPIC_WORDS = ["engine", "orbit", "goalie", "kernel", "scripture", "trade",
                "voltage", "protein", "guitar", "senate", "chess", "camera",
                "glacier", "novel", "harvest", "circuit", "referee", "silk",
                "comet", "lathe"]
_FILLER = ("the a of to and in for on with from by at as is was are be this "
           "that it not or but which their has have had one two new more "
           "people time than about into over such").split()


def synthetic_news20(n: int = 400, class_num: int = CLASS_NUM,
                     seed: int = 0, doc_len: int = 60
                     ) -> List[Tuple[str, int]]:
    """Offline stand-in for get_news20: documents of filler words with a
    class-specific topic word planted throughout — linearly separable by
    vocabulary, like real newsgroup topics. Same return shape."""
    if class_num > len(_TOPIC_WORDS):
        raise ValueError(f"class_num <= {len(_TOPIC_WORDS)}")
    rng = np.random.RandomState(seed)
    texts = []
    for i in range(n):
        label = (i % class_num) + 1
        words = list(rng.choice(_FILLER, size=doc_len))
        for pos in rng.randint(0, doc_len, size=max(3, doc_len // 10)):
            words[pos] = _TOPIC_WORDS[label - 1]
        # guarantee signal near the front so truncated windows still see it
        words[rng.randint(0, min(12, doc_len))] = _TOPIC_WORDS[label - 1]
        texts.append((" ".join(words), label))
    rng.shuffle(texts)
    return texts
