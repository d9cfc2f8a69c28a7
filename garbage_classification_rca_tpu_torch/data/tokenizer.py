"""Host-side tokenizers producing fixed-length int32 arrays.

The reference tokenizes per-sample inside ``__getitem__`` with HF
``encode_plus(max_length, truncation=True, padding='max_length')``
(CustomImageTextFolder.py:301-336). Here tokenization is a host-side
batch step; the device pipeline only ever sees ``[B, L]`` int32
``input_ids`` / ``attention_mask`` (SURVEY.md §2.2: tokens enter the
device pipeline as fixed-length int32 arrays).

Zero-egress reality: HF hub downloads are unavailable, so we ship
self-contained implementations that read vocab files from disk:

  * :class:`WordPieceTokenizer` — BERT-style ``vocab.txt`` (bert,
    distilbert, mobilebert),
  * :class:`ByteLevelBPETokenizer` — GPT-2-style ``vocab.json`` +
    ``merges.txt`` (gpt2, and with <s>/</s> specials roberta, bart),
  * :class:`HashTokenizer` — deterministic hashing fallback so tests,
    benches and synthetic runs are hermetic when no vocab ships.

``get_tokenizer(model_name, vocab_dir)`` picks the right scheme +
special-token convention per text tower (reference text_models.py).
"""

from __future__ import annotations

import json
import os
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Encoded:
    input_ids: np.ndarray       # [B, L] int32
    attention_mask: np.ndarray  # [B, L] int32


class BaseTokenizer:
    pad_id: int

    def encode_one(self, text: str, max_len: int) -> Tuple[List[int], List[int]]:
        raise NotImplementedError

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Encoded:
        ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            tid, tm = self.encode_one(t, max_len)
            ids[i, :len(tid)] = tid
            mask[i, :len(tm)] = tm
        return Encoded(ids, mask)

    def decode(self, ids: Sequence[int]) -> str:
        """Token ids -> text (specials skipped); the multi-token
        generation eval path (blip2_test --max_new_tokens)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# basic whitespace+punctuation pre-tokenizer (BERT BasicTokenizer subset)
# ---------------------------------------------------------------------------


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    if lowercase:
        text = text.lower()
    out: List[str] = []
    buf = ""
    for ch in text:
        if ch.isspace():
            if buf:
                out.append(buf)
                buf = ""
        elif _is_punct(ch):
            if buf:
                out.append(buf)
                buf = ""
            out.append(ch)
        else:
            buf += ch
    if buf:
        out.append(buf)
    return out


class WordPieceTokenizer(BaseTokenizer):
    """Greedy longest-match-first WordPiece over a BERT vocab.txt."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True):
        self.vocab = vocab
        self.lowercase = lowercase
        self.pad_id = vocab.get("[PAD]", 0)
        self.cls_id = vocab.get("[CLS]")
        self.sep_id = vocab.get("[SEP]")
        self.unk_id = vocab.get("[UNK]")

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True):
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                # \r too: a CRLF vocab.txt would otherwise miss EVERY
                # entry (incl. [CLS]/[SEP]) and encode everything to UNK
                vocab[line.rstrip("\r\n")] = i
        return cls(vocab, lowercase)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode_one(self, text: str, max_len: int):
        ids = [self.cls_id]
        for w in basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(w))
        ids = ids[:max_len - 1] + [self.sep_id]
        return ids, [1] * len(ids)

    def decode(self, ids) -> str:
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {i: t for t, i in self.vocab.items()}
        skip = {self.pad_id, self.cls_id, self.sep_id}
        out = []
        for i in ids:
            i = int(i)
            if i in skip:
                continue
            t = inv.get(i, "[UNK]")
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)


class ByteLevelBPETokenizer(BaseTokenizer):
    """GPT-2-style byte-level BPE (vocab.json + merges.txt).

    With bos/eos set, emits RoBERTa/BART-style ``<s> ... </s>``.
    GPT-2 itself uses no specials and pads with eos (reference
    text_models.py:138,156: pad_token = eos_token).
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 bos: Optional[str] = None, eos: Optional[str] = None,
                 pad: Optional[str] = None):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.bos_id = vocab[bos] if bos else None
        self.eos_id = vocab[eos] if eos else None
        self.pad_id = vocab[pad] if pad else (self.eos_id or 0)
        self.byte_enc = _bytes_to_unicode()
        self.cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw):
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_txt, encoding="utf-8") as f:
            for n, line in enumerate(f):
                # only the FIRST line is a header ("#version: ..."):
                # real merges can begin with '#' (GPT-2 has "# #" -> "##"
                # etc.) and must not be dropped, or any text containing
                # '#' runs tokenizes differently from HF
                if (n == 0 and line.startswith("#")) or not line.strip():
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self.cache[token] = word
        return word

    def encode_one(self, text: str, max_len: int):
        import regex as re_mod  # transformers dep, present in image
        pat = re_mod.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
        ids: List[int] = []
        for tok in pat.findall(text):
            btok = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self._bpe(btok) if t in self.vocab)
        n_special = int(self.bos_id is not None) + int(self.eos_id is not None)
        ids = ids[:max_len - n_special]
        if self.bos_id is not None:
            ids = [self.bos_id] + ids
        if self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids, [1] * len(ids)

    def decode(self, ids) -> str:
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {i: t for t, i in self.vocab.items()}
            self._byte_dec = {c: b for b, c in self.byte_enc.items()}
        skip = {self.bos_id, self.eos_id, self.pad_id} - {None}
        text = "".join(inv.get(int(i), "") for i in ids
                       if int(i) not in skip)
        return bytes(self._byte_dec.get(c, ord("?")) for c in text).decode(
            "utf-8", errors="replace")


def _bytes_to_unicode() -> Dict[int, str]:
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


class HashTokenizer(BaseTokenizer):
    """Deterministic hashing tokenizer — hermetic fallback when no vocab
    files ship. Stable across processes (FNV-1a, not Python hash())."""

    def __init__(self, vocab_size: int = 30522, cls_id: int = 101,
                 sep_id: int = 102, pad_id: int = 0, reserved: int = 1000,
                 append_sep: bool = True):
        self.vocab_size = vocab_size
        self.cls_id = cls_id
        self.sep_id = sep_id
        self.pad_id = pad_id
        self.reserved = reserved
        self.append_sep = append_sep

    @staticmethod
    def _fnv1a(s: str) -> int:
        h = 0xcbf29ce484222325
        for b in s.encode("utf-8"):
            h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
        return h

    def encode_one(self, text: str, max_len: int):
        ids = [self.cls_id]
        span = self.vocab_size - self.reserved
        for w in basic_tokenize(text):
            ids.append(self.reserved + self._fnv1a(w) % span)
        if self.append_sep:
            ids = ids[:max_len - 1] + [self.sep_id]
        else:
            ids = ids[:max_len]
        return ids, [1] * len(ids)

    def decode(self, ids) -> str:
        """Hashing is one-way — placeholder ids only (real decoding needs
        --vocab_dir; the CLI warns loudly when hashing is in effect)."""
        skip = {self.pad_id, self.cls_id, self.sep_id}
        return " ".join(f"<{int(i)}>" for i in ids if int(i) not in skip)


# practical sequence length for the garbage texts (a few words or one
# caption sentence). The reference pads to the full max_position_embeddings
# (512-1024, each tower's registry extras carry its max_token_size) and
# burns FLOPs on padding; we default to a 64-token bucket — a
# pure-performance win with identical results for in-range texts. Pass
# ``--seq_len <max_token_size>`` to reproduce reference padding exactly.
DEFAULT_SEQ_LEN = 64


def resolve_vocab_dir(args) -> Optional[str]:
    """vocab_dir for the CLIs: explicit ``--vocab_dir`` wins, else the
    checkpoint's directory (where converted checkpoints ship their vocab
    files), else None (hash fallback with a loud warning)."""
    vd = getattr(args, "vocab_dir", "") or ""
    if vd:
        return vd
    mp = getattr(args, "model_path", "") or ""
    if mp:
        d = os.path.dirname(os.path.abspath(mp))
        if os.path.isdir(d):
            return d
    return None


def get_tokenizer(model_name: str, vocab_dir: Optional[str] = None) -> BaseTokenizer:
    """Pick scheme + specials per text tower; fall back to HashTokenizer.

    The fallback prints a loud warning: hash token ids are meaningless to
    pretrained embeddings (they only make sense for from-scratch training
    or hermetic tests)."""
    wordpiece = {"distilbert", "bert", "mobilebert", "mobile_bert"}
    if vocab_dir:
        if model_name in wordpiece:
            p = os.path.join(vocab_dir, "vocab.txt")
            if os.path.exists(p):
                return WordPieceTokenizer.from_vocab_file(p)
        else:
            vj = os.path.join(vocab_dir, "vocab.json")
            mt = os.path.join(vocab_dir, "merges.txt")
            if os.path.exists(vj) and os.path.exists(mt):
                if model_name in ("roberta", "bart"):
                    return ByteLevelBPETokenizer.from_files(
                        vj, mt, bos="<s>", eos="</s>", pad="<pad>")
                if model_name == "opt":
                    return ByteLevelBPETokenizer.from_files(
                        vj, mt, bos="</s>", pad="<pad>")
                tok = ByteLevelBPETokenizer.from_files(vj, mt)
                # GPT-2 has no pad token; the reference pads with eos
                # (text_models.py:138,156). Without this the pad falls
                # back to id 0 ('!'), which breaks the classifier's
                # last-real-token pooling (gpt2.py PAD_ID=50256) and
                # makes decode() drop legitimate '!' tokens.
                if "<|endoftext|>" in tok.vocab:
                    tok.pad_id = tok.vocab["<|endoftext|>"]
                return tok
    print(f"WARNING: no vocab files for '{model_name}'"
          f"{f' under {vocab_dir}' if vocab_dir else ''} — using the "
          "deterministic HashTokenizer fallback. Hash ids are MEANINGLESS "
          "to pretrained embeddings; pass --vocab_dir (or place vocab.txt / "
          "vocab.json+merges.txt next to the checkpoint) for real runs.")
    if model_name in ("roberta", "bart"):
        return HashTokenizer(vocab_size=50265, cls_id=0, sep_id=2, pad_id=1)
    if model_name == "gpt2":
        return HashTokenizer(vocab_size=50257, cls_id=50256, sep_id=50256,
                             pad_id=50256)
    if model_name == "opt":
        # OPT: GPT-2-style byte BPE, bos=</s>(2), pad=<pad>(1); the hash
        # fallback emits bos + hashed words with NO trailing sep, the same
        # sequence shape as the real-vocab path (bos only)
        return HashTokenizer(vocab_size=50272, cls_id=2, sep_id=2, pad_id=1,
                             append_sep=False)
    return HashTokenizer()


