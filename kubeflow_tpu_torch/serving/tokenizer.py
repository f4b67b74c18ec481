"""First-party byte-level BPE tokenizer (HF tokenizer.json compatible).

Parity: SURVEY.md §2.4 — the reference's huggingfaceserver tokenizes with
the HF `tokenizers` library ([U] kserve:python/huggingfaceserver). This is
a first-party implementation of the same byte-level BPE scheme so the
serving data plane has zero hard deps: it loads the `model.vocab` +
`model.merges` subset of an HF `tokenizer.json` (or GPT-2-style
vocab.json + merges.txt), and ships a tiny trainer to build test fixtures
and domain tokenizers offline (no network in this environment).

Byte-level BPE is lossless by construction: any byte string round-trips
encode -> decode exactly, independent of the pre-tokenizer split.
"""

from __future__ import annotations

import functools
import json
import os
import re
from collections import Counter
from typing import Iterable, Optional, Sequence

# GPT-2-style pre-tokenizer, approximated with stdlib `re` ([^\W\d_] plays
# the \p{L} role, \d the \p{N} role). Contractions, letter runs, digit runs,
# and punctuation split the way byte-level BPE merges expect. Not bit-exact
# with every HF pre_tokenizer config (Llama-3 caps digit runs at 3, etc.) —
# round-tripping is unaffected, but token ids for a foreign checkpoint can
# differ slightly from its native tokenizer on edge cases.
_PRETOK = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[^\W\d_]+| ?\d+| ?[^\s\w]+| ?_+"
    r"|\s+(?!\S)|\s+")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte<->printable-unicode bijection: printable ASCII and
    latin-1 map to themselves; the rest shift into 256+ codepoints so every
    byte has a visible, json-safe character."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteBPETokenizer:
    """vocab: token-string -> id; merges: ordered (left, right) pairs."""

    def __init__(self, vocab: dict[str, int],
                 merges: Sequence[tuple[str, str]],
                 special_tokens: Optional[dict[str, int]] = None,
                 bos_id: Optional[int] = None, eos_id: Optional[int] = None):
        self.vocab = dict(vocab)
        self.merges = {tuple(m): rank for rank, m in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        self.vocab.update(self.special_tokens)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.bos_id = bos_id
        self.eos_id = eos_id
        self._b2u = bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}
        # out-of-vocab ids decode as U+FFFD (see decode): the marker is
        # stored in the byte-level alphabet so both decode paths emit the
        # same UTF-8 bytes for it
        self._oov_tok = "".join(self._b2u[b] for b in "�".encode())
        self._cache: dict[str, list[str]] = {}
        if self.special_tokens:
            self._special_re = re.compile(
                "(" + "|".join(re.escape(t) for t in sorted(
                    self.special_tokens, key=len, reverse=True)) + ")")
        else:
            self._special_re = None

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1

    # ------------------------------ encode ------------------------------

    def _bpe(self, word: str) -> list[str]:
        """Greedily apply the lowest-rank merge until none applies."""
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.merges.get((parts[i], parts[i + 1]), None), i)
                     for i in range(len(parts) - 1)]
            ranked = [(r, i) for r, i in pairs if r is not None]
            if not ranked:
                break
            _, i = min(ranked)
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
        if len(self._cache) < 65536:
            self._cache[word] = parts
        return parts

    def _encode_ordinary(self, text: str) -> list[int]:
        ids: list[int] = []
        for m in _PRETOK.finditer(text):
            word = "".join(self._b2u[b] for b in m.group(0).encode("utf-8"))
            for tok in self._bpe(word):
                if tok in self.vocab:
                    ids.append(self.vocab[tok])
                else:  # unmergeable unknown: fall back to per-byte tokens
                    ids.extend(self.vocab[c] for c in tok)
        return ids

    def encode(self, text: str, *, bos: bool = True,
               eos: bool = False) -> list[int]:
        ids: list[int] = []
        if bos and self.bos_id is not None:
            ids.append(self.bos_id)
        if self._special_re is not None:
            for piece in self._special_re.split(text):
                if not piece:
                    continue
                if piece in self.special_tokens:
                    ids.append(self.special_tokens[piece])
                else:
                    ids.extend(self._encode_ordinary(piece))
        else:
            ids.extend(self._encode_ordinary(text))
        if eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    # ------------------------------ decode ------------------------------

    def decode(self, ids: Iterable[int], *,
               skip_special_tokens: bool = True) -> str:
        special_ids = set(self.special_tokens.values())
        out: list[str] = []
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                # out-of-vocab id (a model whose vocab_size exceeds the
                # tokenizer's can sample these): render U+FFFD instead of
                # silently dropping the token — dropping breaks the
                # "text position <-> token count" invariant the
                # stop-string truncation (and any offset-based consumer)
                # depends on. decode_bytes mirrors this as the UTF-8
                # encoding of U+FFFD so predict and stream stay in parity.
                out.append(self._oov_tok)
                continue
            if int(i) in special_ids:
                if not skip_special_tokens:
                    out.append(tok)
                continue
            out.append(tok)
        buf = bytearray()
        text_parts: list[str] = []
        for tok in out:
            if tok in self.special_tokens:
                text_parts.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()
                text_parts.append(tok)
                continue
            for ch in tok:
                buf.append(self._u2b.get(ch, ord("?")))
        text_parts.append(buf.decode("utf-8", errors="replace"))
        return "".join(text_parts)

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        """Raw UTF-8 bytes for a token-id sequence (specials skipped).
        Token -> bytes is context-free, so callers can decode incrementally
        (feed chunks into codecs' incremental utf-8 decoder) without the
        split-multibyte-character instability of re-decoding prefixes."""
        special_ids = set(self.special_tokens.values())
        buf = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                # out-of-vocab: the UTF-8 bytes of U+FFFD, matching
                # decode()'s rendering (parity contract for incremental
                # consumers like the stop-string matcher)
                buf.extend("�".encode())
                continue
            if int(i) in special_ids:
                continue
            for ch in tok:
                buf.append(self._u2b.get(ch, ord("?")))
        return bytes(buf)

    # ------------------------------ io ------------------------------

    def save(self, path: str) -> None:
        """Write an HF-compatible tokenizer.json (the subset we read back)."""
        merges = sorted(self.merges, key=self.merges.get)
        doc = {
            "version": "1.0",
            "added_tokens": [
                {"id": i, "content": t, "special": True}
                for t, i in sorted(self.special_tokens.items(),
                                   key=lambda kv: kv[1])
            ],
            "model": {
                "type": "BPE",
                "vocab": {t: i for t, i in self.vocab.items()
                          if t not in self.special_tokens},
                "merges": [list(m) for m in merges],
            },
            "kft": {"bos_id": self.bos_id, "eos_id": self.eos_id},
        }
        with open(path, "w") as f:
            json.dump(doc, f, ensure_ascii=False)


def from_tokenizer_json(path: str, *, bos_id: Optional[int] = None,
                        eos_id: Optional[int] = None) -> ByteBPETokenizer:
    with open(path) as f:
        doc = json.load(f)
    model = doc["model"]
    if model.get("type") != "BPE":
        raise ValueError(f"unsupported tokenizer model {model.get('type')!r}")
    vocab = model["vocab"]
    merges = []
    for m in model.get("merges", []):
        if isinstance(m, str):  # old serialization: "left right"
            left, _, right = m.partition(" ")
            merges.append((left, right))
        else:
            merges.append((m[0], m[1]))
    special = {t["content"]: t["id"] for t in doc.get("added_tokens", [])
               if t.get("special", True)}
    kft = doc.get("kft", {})
    bos_id = bos_id if bos_id is not None else kft.get("bos_id")
    eos_id = eos_id if eos_id is not None else kft.get("eos_id")
    if bos_id is None:
        for name in ("<|begin_of_text|>", "<s>", "<bos>"):
            if name in special:
                bos_id = special[name]
                break
    if eos_id is None:
        for name in ("<|end_of_text|>", "<|eot_id|>", "</s>", "<eos>"):
            if name in special:
                eos_id = special[name]
                break
    return ByteBPETokenizer(vocab, merges, special, bos_id=bos_id,
                            eos_id=eos_id)


def load_tokenizer(model_dir: str) -> Optional[ByteBPETokenizer]:
    """Find and load a tokenizer next to an HF checkpoint; None if absent.
    Honors config.json's bos/eos_token_id when present."""
    path = os.path.join(model_dir, "tokenizer.json")
    if not os.path.exists(path):
        return None
    bos_id = eos_id = None
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        bos_id, eos_id = cfg.get("bos_token_id"), cfg.get("eos_token_id")
    return from_tokenizer_json(path, bos_id=bos_id, eos_id=eos_id)


# ------------------------------ training ------------------------------

def train_bpe(texts: Iterable[str], vocab_size: int, *,
              special_tokens: Sequence[str] = ("<|begin_of_text|>",
                                               "<|end_of_text|>"),
              ) -> ByteBPETokenizer:
    """Classic BPE training, small-scale (fixtures, domain tokenizers).

    Base vocab = the 256 byte symbols; merges greedily take the most
    frequent adjacent pair until vocab_size is reached.
    """
    b2u = bytes_to_unicode()
    base = [b2u[b] for b in range(256)]
    vocab: dict[str, int] = {s: i for i, s in enumerate(base)}
    words: Counter[tuple[str, ...]] = Counter()
    for text in texts:
        for m in _PRETOK.finditer(text):
            sym = tuple(b2u[b] for b in m.group(0).encode("utf-8"))
            if sym:
                words[sym] += 1
    merges: list[tuple[str, str]] = []
    target_merges = max(0, vocab_size - 256 - len(special_tokens))
    while len(merges) < target_merges:
        pair_counts: Counter[tuple[str, str]] = Counter()
        for word, freq in words.items():
            for i in range(len(word) - 1):
                pair_counts[(word[i], word[i + 1])] += freq
        if not pair_counts:
            break
        (a, b), freq = pair_counts.most_common(1)[0]
        if freq < 2:
            break
        merges.append((a, b))
        merged = a + b
        vocab[merged] = len(vocab)
        new_words: Counter[tuple[str, ...]] = Counter()
        for word, f in words.items():
            out: list[str] = []
            i = 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_words[tuple(out)] += f
        words = new_words
    special = {t: len(vocab) + i for i, t in enumerate(special_tokens)}
    bos = special.get("<|begin_of_text|>")
    eos = special.get("<|end_of_text|>")
    return ByteBPETokenizer(vocab, merges, special, bos_id=bos, eos_id=eos)
