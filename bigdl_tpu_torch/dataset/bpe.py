"""Byte-pair-encoding tokenizer for the transformer LM pipeline (a copy
of ``bigdl_tpu/dataset/bpe.py``: the same merges, vocabulary and ids for
the same corpus).

The reference's text stack is word-level (``dataset/text.py`` Dictionary,
≙ utils/Dictionary + SentenceTokenizer feeding the PTB example); a
subword vocabulary is what the long-context flagship actually needs, so
this adds the classic BPE recipe (Sennrich et al.): train merges on word
frequencies, encode greedily by merge rank, decode back to text (exact up
to lowercasing and whitespace normalization). Pure host-side Python —
tokenization is data prep, not device compute.

Special ids: 0 <pad>, 1 <unk>, 2 <bos>, 3 <eos>.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

PAD, UNK, BOS, EOS = 0, 1, 2, 3
_SPECIALS = ["<pad>", "<unk>", "<bos>", "<eos>"]
_WORD_END = "</w>"


def _word_tokens(text: str) -> List[str]:
    """Unicode-aware pre-tokenization (deliberately broader than
    dataset/text.py's ASCII word-level ``_TOKEN_RE`` — subword vocabs
    exist to cover arbitrary scripts; mixing the two tokenizers in one
    pipeline will segment differently)."""
    return re.findall(r"\w+|[^\w\s]", text.lower())


class BPETokenizer:
    """Train with ``BPETokenizer.train(corpus, vocab_size)``; ``encode``/
    ``decode``/``save``/``load`` afterwards."""

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 vocab: Sequence[str]):
        self.merges = [tuple(m) for m in merges]
        self.ranks = {m: i for i, m in enumerate(self.merges)}
        self.vocab = list(vocab)
        self.token_to_id: Dict[str, int] = {t: i
                                            for i, t in enumerate(self.vocab)}
        self._cache: Dict[str, List[str]] = {}

    # ------------------------------------------------------------ training
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 1000
              ) -> "BPETokenizer":
        """Learn merges until the vocabulary (specials + characters +
        merged symbols) reaches ``vocab_size``. Pair counts update
        incrementally — only words containing the merged pair are
        re-counted (the Sennrich recipe), keeping training near-linear."""
        word_freq = Counter()
        for text in corpus:
            word_freq.update(_word_tokens(text))
        # each word = tuple of symbols, terminated by the word-end marker
        words = {w: tuple(w) + (_WORD_END,) for w in word_freq}
        symbols = {c for seq in words.values() for c in seq}
        base = len(_SPECIALS) + len(symbols)
        if base > vocab_size:
            raise ValueError(
                f"vocab_size {vocab_size} cannot even hold the specials + "
                f"{len(symbols)} distinct corpus characters ({base}); "
                "raise vocab_size or size embeddings from tok.vocab_size")

        def word_pairs(seq):
            return Counter(zip(seq, seq[1:]))

        pairs = Counter()
        containing: Dict[Tuple[str, str], set] = {}
        for w, seq in words.items():
            for p, c in word_pairs(seq).items():
                pairs[p] += c * word_freq[w]
                containing.setdefault(p, set()).add(w)
        merges: List[Tuple[str, str]] = []
        while base + len(merges) < vocab_size and pairs:
            (a, b), freq = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
            if freq < 2:
                break  # no repeated pair left worth a merge
            merges.append((a, b))
            merged = a + b
            for w in list(containing.get((a, b), ())):
                seq = words[w]
                f = word_freq[w]
                for p, c in word_pairs(seq).items():
                    pairs[p] -= c * f
                    if pairs[p] <= 0:
                        del pairs[p]
                    containing[p].discard(w)
                out, i = [], 0
                while i < len(seq):
                    if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                words[w] = seq = tuple(out)
                for p, c in word_pairs(seq).items():
                    pairs[p] += c * f
                    containing.setdefault(p, set()).add(w)
        vocab = (list(_SPECIALS) + sorted(symbols)
                 + [a + b for a, b in merges])
        return cls(merges, vocab)

    # ------------------------------------------------------------ encoding
    def _bpe_word(self, word: str) -> List[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        seq = list(word) + [_WORD_END]
        while len(seq) > 1:
            best, best_rank, best_i = None, None, None
            for i, pair in enumerate(zip(seq, seq[1:])):
                rank = self.ranks.get(pair)
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best, best_rank, best_i = pair, rank, i
            if best is None:
                break
            seq[best_i:best_i + 2] = [best[0] + best[1]]
        self._cache[word] = seq
        return seq

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = [BOS] if add_bos else []
        for word in _word_tokens(text):
            for sym in self._bpe_word(word):
                ids.append(self.token_to_id.get(sym, UNK))
        if add_eos:
            ids.append(EOS)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Inverse of encode up to case (input is lowercased) and
        whitespace normalization; punctuation re-attaches to the
        preceding word ("hello , world" -> "hello, world")."""
        parts = []
        for i in ids:
            if i in (PAD, BOS, EOS):
                continue
            parts.append(self.vocab[i] if 0 <= int(i) < len(self.vocab)
                         else _SPECIALS[UNK])
        text = "".join(parts).replace(_WORD_END, " ")
        text = re.sub(r" +", " ", text).strip()
        # reattach punctuation, but never fuse '<' — that would glue
        # "<unk>" placeholders onto the preceding word
        return re.sub(r"\s+([^\w\s<])", r"\1", text)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges, "vocab": self.vocab}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["vocab"])
