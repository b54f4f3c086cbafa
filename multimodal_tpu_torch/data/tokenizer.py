"""CLIP byte-pair-encoding tokenizer (port of ``multimodal_tpu/data/tokenizer.py``): the
Python BPE, and ``tokenize``'s route to the native one for ASCII batches.

Bit-identical to the reference on the standard 49,408-token CLIP vocabulary, which is read
from the JAX package's ``data/assets`` by path. The word-split pattern needs the Unicode
classes ``\\p{L}`` and ``\\p{N}``: the third-party ``regex`` module has them, stdlib ``re``
does not. Where ``regex`` is missing, the exact classes are built once, at first use, from
``unicodedata.category`` (``L*`` letters, ``N*`` numbers), together with ``regex``'s
whitespace set, which differs from stdlib ``\\s`` at U+001C..U+001F. The shortcut
``[^\\W\\d_]`` is not exact: stdlib ``\\w`` also counts the ``No`` category
(``"x²½"`` splits as ``x``, ``²``, ``½`` under ``regex``). Checked over every code point
assigned in the interpreter's Unicode database, the two engines split identically; code
points that only a newer Unicode version than ``unicodedata``'s assigns can differ.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
import sys
import unicodedata

import numpy as np

from multimodal_tpu_torch.data.textfix import fix_text
from multimodal_tpu_torch.native import bindings
from multimodal_tpu_torch.paths import BPE_VOCAB_PATH

try:
    import regex as _regex
except ImportError:
    _regex = None

try:  # ftfy fixes mojibake; the vendored textfix subset stands in when it is absent
    import ftfy
except ImportError:
    ftfy = None

CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

_TOKEN_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[{L}]+|[{N}]|[^{S}{LF}{NF}]+"
)
# the Unicode White_Space set, which is what regex's \s matches
_WHITESPACE = "\t\n\x0b\x0c\r \x85\xa0  -     　"


def _ranges(cps: list) -> str:
    """A character-class body for sorted code points, as escaped ranges."""
    parts, i = [], 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        parts.append(f"\\U{cps[i]:08x}" if i == j else f"\\U{cps[i]:08x}-\\U{cps[j]:08x}")
        i = j + 1
    return "".join(parts)


def _stdlib_classes() -> dict:
    """Bodies for ``\\p{L}`` and ``\\p{N}`` as ``regex`` applies them under IGNORECASE.

    A positive class matches a code point by its own category. A negated class also
    excludes code points whose one-character case variant is in the class: U+0345 (``Mn``,
    folds to iota) matches neither ``[\\p{L}]`` nor ``[^\\s\\p{L}\\p{N}]`` and is dropped."""
    own = {"L": [], "N": []}
    folded = {"L": [], "N": []}
    for cp in range(sys.maxunicode + 1):
        ch = chr(cp)
        top = unicodedata.category(ch)[0]
        if top in own:
            own[top].append(cp)
            folded[top].append(cp)
            continue
        for v in {ch.lower(), ch.upper(), ch.casefold()} - {ch}:
            if len(v) == 1 and unicodedata.category(v)[0] in folded:
                folded[unicodedata.category(v)[0]].append(cp)
                break
    return {"L": _ranges(own["L"]), "N": _ranges(own["N"]),
            "LF": _ranges(folded["L"]), "NF": _ranges(folded["N"])}


@functools.lru_cache(maxsize=2)
def _patterns(use_regex: bool):
    """(word-split pattern, whitespace-run pattern), compiled once per engine."""
    if use_regex:
        body = _TOKEN_PATTERN.format(L=r"\p{L}", N=r"\p{N}", S=r"\s", LF=r"\p{L}", NF=r"\p{N}")
        return _regex.compile(body, _regex.IGNORECASE), _regex.compile(r"\s+")
    # stdlib re would also fold the positive classes (matching U+0345 as a letter), so the
    # class alternatives run case-sensitively and carry the folded sets explicitly
    specials, classes = _TOKEN_PATTERN.split("|[", 1)
    body = f"{specials}|(?-i:[{classes})".format(S=_WHITESPACE, **_stdlib_classes())
    return re.compile(body, re.IGNORECASE), re.compile(f"[{_WHITESPACE}]+")


@functools.lru_cache()
def byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode-char table (the GPT-2/CLIP convention)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


class SimpleTokenizer:
    """CLIP BPE: lowercase, word split, byte-encode, iterative lowest-rank pair merges.

    ``use_regex`` picks the word-split engine: None takes ``regex`` when it is importable
    and the exact stdlib classes otherwise; both split identically."""

    def __init__(self, bpe_path: str = BPE_VOCAB_PATH, use_regex: bool | None = None):
        if use_regex is None:
            use_regex = _regex is not None
        if use_regex and _regex is None:
            raise ImportError("use_regex=True needs the 'regex' module")
        self._token_re, self._ws_re = _patterns(use_regex)
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a version header; the CLIP vocab uses the first 48,894 merge rules
        merges = [tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]]
        chars = list(self.byte_encoder.values())
        vocab = chars + [c + "</w>" for c in chars]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_ranks = {m: i for i, m in enumerate(merges)}
        self._bpe_cache = {SOT_TOKEN: (SOT_TOKEN,), EOT_TOKEN: (EOT_TOKEN,)}
        self.vocab_size = len(vocab)
        self.sot_token_id = self.encoder[SOT_TOKEN]
        self.eot_token_id = self.encoder[EOT_TOKEN]

    def _clean(self, text: str) -> str:
        if ftfy is not None:
            text = ftfy.fix_text(text)
        else:
            text = unicodedata.normalize("NFC", fix_text(text))
        text = html.unescape(html.unescape(text))
        return self._ws_re.sub(" ", text).strip()

    def _bpe(self, token: str) -> tuple:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            best = min(pairs, key=lambda p: self.merge_ranks.get(p, float("inf")))
            if best not in self.merge_ranks:
                break
            merged = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == best[0] and parts[i + 1] == best[1]:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        result = tuple(parts)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> list:
        ids = []
        for word in self._token_re.findall(self._clean(text).lower()):
            word_bytes = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(word_bytes))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH,
             tokenizer: SimpleTokenizer | None = None, use_native: bool = True) -> np.ndarray:
    """Batch tokenize to ``[N, context_length]`` int32: SOT/EOT framing, zero padding, and
    over-long sequences truncated with the final slot forced to EOT.

    With the default vocabulary a batch of ASCII captions without HTML entities goes to the
    native tokenizer (``native/bpe_tokenizer.cc``, the same ids); a batch that needs Unicode
    normalization or HTML unescaping, a custom ``tokenizer`` or ``use_native=False`` runs the
    Python one."""
    if isinstance(texts, str):
        texts = [texts]
    if use_native and tokenizer is None:
        out = bindings.bpe_encode_batch(list(texts), BPE_VOCAB_PATH, context_length)
        if out is not None:
            return out
    tok = tokenizer or default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        full = [tok.sot_token_id] + tok.encode(text) + [tok.eot_token_id]
        if len(full) > context_length:
            full = full[:context_length]
            full[-1] = tok.eot_token_id
        out[row, : len(full)] = full
    return out
