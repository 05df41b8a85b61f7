"""Tokenizer loading: the HuggingFace umT5 tokenizer when `transformers` and
local files are available, else a deterministic hash tokenizer (the only one
on a machine without `transformers`). The hash tokenizer hashes each word
with BLAKE2b, so a prompt gives the same ids in every process (the JAX
package's uses Python's salted hash(), whose ids agree only within one
process)."""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


def _word_hash(word: str) -> int:
    return int.from_bytes(hashlib.blake2b(word.encode(), digest_size=8).digest(), "little")


class HashTokenizer:
    """Whitespace words -> hashed ids. Not linguistically meaningful."""

    def __init__(self, vocab_size: int = 256384, eos_id: int = 1, pad_id: int = 0):
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        self.pad_id = pad_id

    def __call__(self, texts, max_length: int = 512, **_):
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [2 + (_word_hash(w) % (self.vocab_size - 2)) for w in t.split()]
            toks = toks[: max_length - 1] + [self.eos_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(path_or_name: Optional[str] = None, vocab_size: int = 256384):
    """HF AutoTokenizer from local files when a path is given and loadable,
    else the hash tokenizer."""
    if path_or_name is not None:
        try:
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(path_or_name)
        except (ImportError, OSError, ValueError):
            return HashTokenizer(vocab_size)

        def call(texts, max_length=512):
            out = tok(texts if isinstance(texts, list) else [texts],
                      padding="max_length", max_length=max_length,
                      truncation=True, add_special_tokens=True,
                      return_tensors="np")
            return {"input_ids": out["input_ids"].astype(np.int32),
                    "attention_mask": out["attention_mask"].astype(np.int32)}

        return call
    return HashTokenizer(vocab_size)
