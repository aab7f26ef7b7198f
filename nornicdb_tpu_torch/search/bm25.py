"""BM25 fulltext index (in-memory inverted index): a copy of
``nornicdb_tpu/search/bm25.py``, incrementally maintained from storage
events. Host Python, as in the reference."""

from __future__ import annotations

import math
import re
import threading
from collections import Counter, defaultdict

_TOKEN_RE = re.compile(r"\w+", re.UNICODE)

# minimal english stopword list; BM25 idf handles most of the rest
_STOPWORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the "
    "to was were will with".split()
)


def tokenize(text: str) -> list[str]:
    return [t for t in (m.group(0).lower() for m in _TOKEN_RE.finditer(text))
            if t not in _STOPWORDS]


class BM25Index:
    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self._lock = threading.RLock()
        # term -> {doc: tf}
        self._postings: dict[str, dict[str, int]] = defaultdict(dict)
        self._doc_terms: dict[str, list[str]] = {}  # doc -> its terms
        self._doc_len: dict[str, int] = {}
        self._total_len = 0

    def __len__(self) -> int:
        return len(self._doc_len)

    def index(self, doc_id: str, text: str) -> None:
        with self._lock:
            self._remove_locked(doc_id)
            toks = tokenize(text)
            if not toks:
                return
            counts = Counter(toks)
            for term, tf in counts.items():
                self._postings[term][doc_id] = tf
            self._doc_terms[doc_id] = list(counts)
            self._doc_len[doc_id] = len(toks)
            self._total_len += len(toks)

    def remove(self, doc_id: str) -> None:
        with self._lock:
            self._remove_locked(doc_id)

    def _remove_locked(self, doc_id: str) -> None:
        n = self._doc_len.pop(doc_id, None)
        if n is None:
            return
        self._total_len -= n
        for term in self._doc_terms.pop(doc_id, ()):
            postings = self._postings.get(term)
            if postings is not None:
                postings.pop(doc_id, None)
                if not postings:
                    del self._postings[term]

    def search(self, query: str, limit: int = 10) -> list[tuple[str, float]]:
        with self._lock:
            n_docs = len(self._doc_len)
            if n_docs == 0:
                return []
            avg_len = self._total_len / n_docs
            scores: dict[str, float] = defaultdict(float)
            for term in set(tokenize(query)):
                postings = self._postings.get(term)
                if not postings:
                    continue
                df = len(postings)
                idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
                for doc_id, tf in postings.items():
                    dl = self._doc_len[doc_id]
                    denom = tf + self.k1 * (1 - self.b + self.b * dl / avg_len)
                    scores[doc_id] += idf * tf * (self.k1 + 1) / denom
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
            return ranked[:limit]
