"""Text pipeline: tokenization, vocabulary, LM sample building (port of
``bigdl_tpu/dataset/text.py``: host code, the JAX package's tokens, ids
and dictionaries for the same input).

Reference: dataset/text/ — ``SentenceSplitter``/``SentenceTokenizer``
(OpenNLP-backed; here regex — the model-file dependency is absorbed),
``Dictionary`` (dataset/text/Dictionary.scala), ``TextToLabeledSentence``,
``LabeledSentenceToSample`` — the chain feeding the SimpleRNN language
model (models/rnn/Train.scala, BASELINE config 5).
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

SENTENCE_START = "SENTENCESTART"
SENTENCE_END = "SENTENCEEND"

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_TOKEN_RE = re.compile(r"[A-Za-z0-9']+|[^\sA-Za-z0-9]")


class SentenceSplitter(Transformer):
    """Raw text blobs → sentences (≙ dataset/text/SentenceSplitter.scala)."""

    def __call__(self, it: Iterator[str]) -> Iterator[str]:
        for blob in it:
            for sent in _SENT_RE.split(blob):
                sent = sent.strip()
                if sent:
                    yield sent


class SentenceTokenizer(Transformer):
    """Sentence → token list, lowercased, with optional start/end markers
    (≙ dataset/text/SentenceTokenizer.scala + SentenceBiPadding)."""

    def __init__(self, add_markers: bool = True, lower: bool = True):
        self.add_markers = add_markers
        self.lower = lower

    def __call__(self, it: Iterator[str]) -> Iterator[List[str]]:
        for sent in it:
            if self.lower:
                sent = sent.lower()
            toks = _TOKEN_RE.findall(sent)
            if not toks:
                continue
            if self.add_markers:
                toks = [SENTENCE_START] + toks + [SENTENCE_END]
            yield toks


class Dictionary:
    """Frequency-ranked vocabulary with an OOV bucket
    (≙ dataset/text/Dictionary.scala: vocabSize most-frequent words; every
    other token maps to the trailing "unknown" index)."""

    UNK = "<unk>"

    def __init__(self, sentences: Optional[Iterable[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None):
        self._word2idx = {}
        self._idx2word = []
        if sentences is not None:
            counts = Counter()
            for toks in sentences:
                counts.update(toks)
            keep = (counts.most_common(vocab_size) if vocab_size
                    else sorted(counts.items()))
            for word, _ in keep:
                self._word2idx[word] = len(self._idx2word)
                self._idx2word.append(word)
            self._word2idx.setdefault(self.UNK, len(self._idx2word))
            if self._idx2word[-1:] != [self.UNK]:
                self._idx2word.append(self.UNK)

    def vocab_size(self) -> int:
        """Total size including the OOV bucket."""
        return len(self._idx2word)

    def get_index(self, word: str) -> int:
        return self._word2idx.get(word, self._word2idx[self.UNK])

    def get_word(self, index: int) -> str:
        return self._idx2word[index]

    def word2index(self) -> dict:
        return dict(self._word2idx)

    def index2word(self) -> dict:
        return {i: w for i, w in enumerate(self._idx2word)}

    def save(self, folder: str) -> None:
        """≙ Dictionary.save: dictionary.txt + discard info."""
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "dictionary.txt"), "w") as f:
            json.dump(self._word2idx, f)

    @classmethod
    def load(cls, folder_or_file: str) -> "Dictionary":
        path = folder_or_file
        if os.path.isdir(path):
            path = os.path.join(path, "dictionary.txt")
        d = cls()
        with open(path) as f:
            d._word2idx = json.load(f)
        d._idx2word = [None] * len(d._word2idx)
        for w, i in d._word2idx.items():
            d._idx2word[i] = w
        return d


class LabeledSentence:
    """Index sequence + shifted target (≙ dataset/text/LabeledSentence.scala)."""

    __slots__ = ("data", "label")

    def __init__(self, data: np.ndarray, label: np.ndarray):
        self.data = data
        self.label = label


class TextToLabeledSentence(Transformer):
    """Token list → (w[0..n-2], w[1..n-1]) index pair
    (≙ dataset/text/TextToLabeledSentence.scala)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, it: Iterator[Sequence[str]]) -> Iterator[LabeledSentence]:
        for toks in it:
            if len(toks) < 2:
                continue
            idx = np.array([self.dictionary.get_index(t) for t in toks], np.int32)
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence → Sample: one-hot (T, vocab) features + **1-based**
    (T,) labels (≙ dataset/text/LabeledSentenceToSample.scala; the reference
    feeds one-hot rows into SimpleRNN and 1-based targets into
    TimeDistributedCriterion).  ``fixed_length`` pads/truncates to one
    T for every sample."""

    def __init__(self, vocab_size: int, fixed_length: Optional[int] = None,
                 one_hot: bool = True):
        self.vocab_size = vocab_size
        self.fixed_length = fixed_length
        self.one_hot = one_hot

    def __call__(self, it: Iterator[LabeledSentence]) -> Iterator[Sample]:
        for ls in it:
            data, label = ls.data, ls.label
            t = self.fixed_length or data.shape[0]
            if data.shape[0] > t:
                data, label = data[:t], label[:t]
            pad = t - data.shape[0]
            if pad:
                # pad with SENTENCE_END-style index 0 features and label 1
                data = np.concatenate([data, np.zeros(pad, np.int32)])
                label = np.concatenate([label, np.zeros(pad, np.int32)])
            if self.one_hot:
                feat = np.zeros((t, self.vocab_size), np.float32)
                feat[np.arange(t), data] = 1.0
            else:
                feat = data.astype(np.float32)
            yield Sample(feat, (label + 1).astype(np.float32))
