"""BERT WordPiece tokenizer for the Grounding DINO text tower, without
transformers (absent from the GPU machine): what
``transformers.BertTokenizer(vocab_file)`` does for the segmenter's
prompts. Text is cleaned (control characters dropped, whitespace unified),
CJK characters spaced, NFC-normalized, lower-cased with accents stripped
(NFD, combining marks dropped), split on whitespace and punctuation, then
each word split greedily into the longest vocabulary pieces ("##" marks a
continuation); a word with no split, or longer than 100 characters, is
[UNK]. Special tokens written in the text ([CLS], [SEP], ...) stay whole.
"""

from __future__ import annotations

import glob
import os
import re
import unicodedata
from typing import Dict, List, Optional

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
# the segmenter's vocabulary when no BERT vocab is given or cached (fresh
# random weights only): unknown prompt words map to [UNK]
SMOKE_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."] \
    + ["car", "person", "cat", "dog", "chair", "table", "tree", "building", "object",
       "ball", "cup", "box"]


def load_vocab(path: str) -> Dict[str, int]:
    """vocab.txt: one token per line, its id the line number."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def cached_vocab(repo: str = "bert-base-uncased") -> Optional[str]:
    """vocab.txt of `repo` in the local Hugging Face hub cache ($HF_HUB_CACHE,
    else $HF_HOME/hub, else ~/.cache/huggingface/hub), or None."""
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                  "huggingface"), "hub")
    found = sorted(glob.glob(os.path.join(hub, f"models--{repo.replace('/', '--')}",
                                          "snapshots", "*", "vocab.txt")))
    return found[-1] if found else None


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """The subset of BertTokenizer the segmenter calls: __call__(text,
    add_special_tokens) -> {"input_ids"}, tokenize, convert_tokens_to_ids,
    cls_token_id, sep_token_id."""

    unk_token, cls_token, sep_token = "[UNK]", "[CLS]", "[SEP]"
    max_input_chars_per_word = 100

    def __init__(self, vocab_file: str):
        self.vocab = load_vocab(vocab_file)
        specials = [t for t in SPECIALS if t in self.vocab]
        self._special_re = re.compile("(" + "|".join(map(re.escape, specials)) + ")") \
            if specials else None

    @property
    def cls_token_id(self) -> int:
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    def _basic(self, text: str) -> List[str]:
        text = "".join(" " if _is_whitespace(c) else c for c in text
                       if not (ord(c) in (0, 0xFFFD) or _is_control(c)))
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        out: List[str] = []
        for tok in unicodedata.normalize("NFC", text).split():
            tok = "".join(c for c in unicodedata.normalize("NFD", tok.lower())
                          if unicodedata.category(c) != "Mn")
            word = ""
            for c in tok:
                if _is_punctuation(c):
                    if word:
                        out.append(word)
                    out.append(c)
                    word = ""
                else:
                    word += c
            if word:
                out.append(word)
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = ("##" if start else "") + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            else:
                return [self.unk_token]
            pieces.append(sub)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        parts = self._special_re.split(text) if self._special_re else [text]
        out: List[str] = []
        for part in parts:
            if part in SPECIALS and part in self.vocab:
                out.append(part)
            else:
                for word in self._basic(part):
                    out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens):
        unk = self.vocab.get(self.unk_token)
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def __call__(self, text: str, add_special_tokens: bool = True) -> dict:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return {"input_ids": ids}
