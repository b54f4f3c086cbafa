"""Minimal vendored fix-text: mojibake repair for web captions (the ftfy subset).

A verbatim port of ``multimodal_tpu/data/textfix.py`` (pure Python; importing it from the
JAX package would run ``multimodal_tpu/data/__init__``, which imports jax).

The reference tokenizer unconditionally applies ``ftfy.fix_text``
(align_clip/tokenizer.py:60-63) before BPE; ftfy is not in the TPU image, and silently
falling back to plain NFC lets CC12M-style dirty captions ("CafÃ©", "donâ€™t") tokenize
differently across environments. This module vendors the part of ftfy that matters for
those captions — UTF-8 bytes mis-decoded as windows-1252/latin-1 ("mojibake"), including
the double-encoded case — using ftfy's own core mechanism: re-encode the text via
*sloppy* windows-1252 (cp1252 with the five unmapped bytes 0x81/0x8D/0x8F/0x90/0x9D
falling back to their latin-1 C1 controls) and accept the fix only when the byte string
decodes as STRICT valid UTF-8. Valid UTF-8 arising by accident from genuine Latin text is
vanishingly rare (a bare "café" fails the decode and passes through untouched), which is
the same safety argument ftfy's fix_encoding makes.

Out of scope (rare in captions, documented): partial/mixed mojibake inside one string,
lone surrogates, fullwidth-character normalization, terminal escapes.
"""

from __future__ import annotations

import codecs
import functools


@functools.lru_cache()
def _sloppy_cp1252():
    """(char -> byte) encode map and (byte -> char) decode map for sloppy-windows-1252."""
    enc, dec = {}, {}
    for b in range(256):
        try:
            ch = bytes([b]).decode("cp1252")
        except UnicodeDecodeError:  # 0x81 0x8D 0x8F 0x90 0x9D: latin-1 C1 controls
            ch = chr(b)
        dec[b] = ch
        enc.setdefault(ch, b)
    return enc, dec


def _encode_sloppy(text: str) -> bytes | None:
    enc, _ = _sloppy_cp1252()
    out = bytearray()
    for ch in text:
        b = enc.get(ch)
        if b is None:
            return None  # genuine non-Latin-1 content: cannot be cp1252 mojibake
        out.append(b)
    return bytes(out)


def fix_text(text: str, max_passes: int = 3) -> str:
    """Undo UTF-8-read-as-cp1252 mojibake; identity on clean text.

    Repeated passes unwind double-encoding ("CafÃƒÂ©" -> "CafÃ©" -> "Café"), mirroring
    ftfy's fixed-point loop. Only rewrites when the sloppy-cp1252 re-encoding forms
    strictly valid UTF-8 that differs from the input.
    """
    if text.isascii():
        return text
    for _ in range(max_passes):
        raw = _encode_sloppy(text)
        if raw is None:
            break
        try:
            fixed = raw.decode("utf-8", errors="strict")
        except UnicodeDecodeError:
            break
        if fixed == text:
            break
        text = fixed
        if text.isascii():
            break
    return text


# keep a codecs hook so `codecs.lookup` callers (none today) could register it later
__all__ = ["fix_text"]
