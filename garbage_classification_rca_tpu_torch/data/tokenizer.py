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
    benches and synthetic runs are hermetic when no vocab ships,
  * :class:`HFTokenizer` — a Hugging Face ``tokenizer.json`` (byte-level
    BPE; the Llama paraphraser's), without ``tokenizers``.

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
        if token not in self.cache:
            self.cache[token] = bpe_merge(token, self.ranks)
        return self.cache[token]

    def encode_one(self, text: str, max_len: int):
        import regex as re_mod  # transformers dep, present in image
        pat = re_mod.compile(GPT2_PATTERN)
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


# GPT-2's pre-tokenizer pattern (the ByteLevel pre-tokenizer's regex)
GPT2_PATTERN = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
                r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


def bpe_merge(token: str, ranks: Dict[Tuple[str, str], int]) -> List[str]:
    """Byte-level BPE of one pre-token: merge the adjacent pair of the
    lowest rank, every occurrence left to right, until none has a rank."""
    word = list(token)
    while len(word) > 1:
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        best = min(pairs, key=lambda p: ranks.get(p, 1 << 30))
        if best not in ranks:
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
    return word


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


# transformers' clean_up_tokenization: the spaces its decode drops
_CLEANUPS = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
             (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
             (" 've", "'ve"), (" 're", "'re"))


def _token_content(tok) -> Optional[str]:
    """A tokenizer_config.json special token: a string or {"content"}."""
    return tok.get("content") if isinstance(tok, dict) else tok


class HFTokenizer:
    """A Hugging Face ``tokenizer.json`` tokenizer (byte-level BPE), read
    without ``tokenizers`` or ``transformers``, as the paraphraser
    (``data/synonymize.make_hf_llm_fn``) calls it:

    * ``added_tokens`` are split out of the text first (leftmost, longest
      first) and map to their ids;
    * the rest goes through the pre-tokenizer: ``ByteLevel`` (GPT-2's
      pattern when ``use_regex``), ``Split`` with a regex pattern and the
      ``Isolated`` behaviour (Llama-3's ``\\p{L}`` / ``\\p{N}`` pattern),
      or a ``Sequence`` of them;
    * then the BPE of ``model.vocab`` / ``model.merges`` (pairs as "a b"
      strings or two-item lists), a whole pre-token that is in the
      vocabulary taken as it is under ``ignore_merges``;
    * no normalizer and no post-processor: the paraphraser encodes with
      ``add_special_tokens=False``;
    * ``batch`` pads on the left with the pad id (the eos when the
      tokenizer has none), mask 0 there;
    * ``decode`` maps byte-level characters back to bytes (a token with a
      character outside the byte table keeps its own UTF-8), drops the
      ``special`` added tokens on request and, where
      ``tokenizer_config.json`` asks, transformers' cleanup of spaces.

    ``tokenizer_config.json`` gives the bos / eos / pad / unk tokens, the
    ``chat_template`` (or ``chat_template.jinja`` beside it) and
    ``clean_up_tokenization_spaces``."""

    def __init__(self, spec: Dict, config: Optional[Dict] = None,
                 chat_template: Optional[str] = None):
        import regex

        config = config or {}
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"not a BPE tokenizer: {model.get('type')}")
        if spec.get("normalizer") not in (None, {"type": "Sequence",
                                                 "normalizers": []}):
            raise ValueError("tokenizer.json normalizers are not read: "
                             f"{spec['normalizer']}")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ranks = {}
        for i, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(a, b)] = i
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens",
                                                              ())}
        self.special_ids = {t["id"] for t in spec.get("added_tokens", ())
                            if t.get("special")}
        self.inv = {i: t for t, i in self.vocab.items()}
        self.inv.update({i: t for t, i in self.added.items()})
        self.added_re = (regex.compile("|".join(
            regex.escape(t) for t in sorted(self.added, key=len,
                                            reverse=True)))
            if self.added else None)
        self.steps = self._pre_tokenizer(spec.get("pre_tokenizer"), regex)
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {c: b for b, c in self.byte_enc.items()}
        self.cache: Dict[str, List[str]] = {}
        names = {k: _token_content(config.get(k))
                 for k in ("bos_token", "eos_token", "pad_token",
                           "unk_token")}
        self.bos_token, self.eos_token = names["bos_token"], names["eos_token"]
        self.pad_token = names["pad_token"] or self.eos_token
        self.unk_token = names["unk_token"]
        self.eos_token_id = self.token_id(self.eos_token)
        self.pad_token_id = self.token_id(self.pad_token)
        self.clean_up = bool(config.get("clean_up_tokenization_spaces",
                                        False))
        self.chat_template = chat_template or config.get("chat_template")

    @classmethod
    def from_dir(cls, path: str) -> "HFTokenizer":
        """The tokenizer ``save_pretrained`` wrote into `path`."""
        with open(os.path.join(path, "tokenizer.json"),
                  encoding="utf-8") as f:
            spec = json.load(f)
        config, template = {}, None
        cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(cfg):
            with open(cfg, encoding="utf-8") as f:
                config = json.load(f)
        jinja = os.path.join(path, "chat_template.jinja")
        if os.path.isfile(jinja):
            with open(jinja, encoding="utf-8") as f:
                template = f.read()
        return cls(spec, config, template)

    def token_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        return self.added.get(token, self.vocab.get(token))

    def special_tokens(self) -> Dict[str, str]:
        """The chat template's special-token variables."""
        return {k: v for k, v in (("bos_token", self.bos_token),
                                  ("eos_token", self.eos_token),
                                  ("unk_token", self.unk_token),
                                  ("pad_token", self.pad_token))
                if v is not None}

    @staticmethod
    def _pre_tokenizer(spec, regex):
        """The pre-tokenizer as a list of (split function, byte-map)."""
        if spec is None:
            return [(None, False)]
        kind = spec["type"]
        if kind == "Sequence":
            return [step for sub in spec["pretokenizers"]
                    for step in HFTokenizer._pre_tokenizer(sub, regex)]
        if kind == "ByteLevel":
            if spec.get("add_prefix_space"):
                raise ValueError("ByteLevel add_prefix_space is not read")
            pat = (regex.compile(GPT2_PATTERN)
                   if spec.get("use_regex", True) else None)
            return [(pat, True)]
        if kind == "Split":
            if spec.get("behavior") != "Isolated" or spec.get("invert") \
                    or "Regex" not in spec["pattern"]:
                raise ValueError(f"Split is read with a Regex pattern and "
                                 f"the Isolated behaviour only: {spec}")
            return [(regex.compile(spec["pattern"]["Regex"]), False)]
        raise ValueError(f"pre-tokenizer {kind} is not read")

    def _pre_tokens(self, text: str) -> List[str]:
        pieces = [text]
        for pat, byte_map in self.steps:
            if pat is not None:
                out = []
                for piece in pieces:
                    # Isolated: each match a piece, each gap between too
                    at = 0
                    for m in pat.finditer(piece):
                        if m.start() > at:
                            out.append(piece[at:m.start()])
                        if m.end() > m.start():
                            out.append(m.group())
                        at = m.end()
                    if at < len(piece):
                        out.append(piece[at:])
                pieces = out
            if byte_map:
                pieces = ["".join(self.byte_enc[b] for b in p.encode("utf-8"))
                          for p in pieces]
        return pieces

    def _word_ids(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        if word not in self.cache:
            self.cache[word] = bpe_merge(word, self.ranks)
        return [self.vocab[t] for t in self.cache[word] if t in self.vocab]

    def encode(self, text: str) -> List[int]:
        """`text`'s ids, no special token added around them."""
        ids: List[int] = []
        at = 0
        spans = ([] if self.added_re is None
                 else list(self.added_re.finditer(text)))
        for m in spans + [None]:
            end = len(text) if m is None else m.start()
            if end > at:
                for word in self._pre_tokens(text[at:end]):
                    ids.extend(self._word_ids(word))
            if m is not None:
                ids.append(self.added[m.group()])
                at = m.end()
        return ids

    def batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, attention mask), int64 [B, L]: left-padded to the longest
        text with the pad id."""
        enc = [self.encode(t) for t in texts]
        n = max(len(e) for e in enc)
        ids = np.full((len(enc), n), self.pad_token_id, np.int64)
        mask = np.zeros((len(enc), n), np.int64)
        for i, e in enumerate(enc):
            if e:
                ids[i, n - len(e):] = e
                mask[i, n - len(e):] = 1
        return ids, mask

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            tok = self.inv.get(i)
            if tok is None:
                continue
            if all(c in self.byte_dec for c in tok):
                out.extend(self.byte_dec[c] for c in tok)
            else:
                out.extend(tok.encode("utf-8"))
        text = out.decode("utf-8", errors="replace")
        if self.clean_up:
            for a, b in _CLEANUPS:
                text = text.replace(a, b)
        return text

    def batch_decode(self, rows, skip_special_tokens: bool = False
                     ) -> List[str]:
        return [self.decode(r, skip_special_tokens) for r in rows]


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


