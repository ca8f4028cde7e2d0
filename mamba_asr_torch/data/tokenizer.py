"""The character tokenizer of the CTC recipes (port of
mamba_asr_tpu/data/tokenizer.py: CharTokenizer, load_tokenizer).

Ids follow the reference configs: pad == blank == 0, bos 1, eos 2, unk 3,
then the characters in sorted order. The JSON file is the JAX package's
(`{"type": "char", "chars": [...]}`), so either package loads the
other's `tokenizer_char.json`. Subword (BPE / unigram) tokenizers need
the `tokenizers` package and come with the S2S slice; `load_tokenizer`
raises for their files.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Sequence

PAD_ID = 0   # also the CTC blank
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
_SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]


class CharTokenizer:
    """Character tokenizer with the reference's special ids."""

    def __init__(self, chars: Sequence[str]):
        self.chars = list(chars)
        self.id_to_tok = _SPECIALS + self.chars
        self.tok_to_id = {t: i for i, t in enumerate(self.id_to_tok)}

    @classmethod
    def fit(cls, corpus: Iterable[str], vocab_size: Optional[int] = None) -> "CharTokenizer":
        """The character set of the text: the most frequent first when
        `vocab_size` cuts it, stored sorted."""
        freq = {}
        for line in corpus:
            for ch in line:
                freq[ch] = freq.get(ch, 0) + 1
        chars = sorted(freq, key=lambda c: (-freq[c], c))
        if vocab_size is not None:
            chars = chars[: vocab_size - len(_SPECIALS)]
        return cls(sorted(chars))

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_tok)

    def encode(self, text: str) -> List[int]:
        return [self.tok_to_id.get(ch, UNK_ID) for ch in text]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.id_to_tok[i] for i in ids
                       if len(_SPECIALS) <= i < len(self.id_to_tok))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"type": "char", "chars": self.chars}, f)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        if d.get("type") != "char":
            raise ValueError(f"{path} is not a char tokenizer")
        return cls(d["chars"])


def load_tokenizer(path: str) -> CharTokenizer:
    """Load a tokenizer from its JSON file (char only in the port)."""
    with open(path, encoding="utf-8") as f:
        head = f.read(4096)
    if '"type": "char"' in head:
        return CharTokenizer.load(path)
    raise NotImplementedError(
        f"{path}: subword tokenizers are not ported (ROADMAP slice 3b item 2)")
