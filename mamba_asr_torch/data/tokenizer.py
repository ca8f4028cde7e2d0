"""Tokenizers (port of mamba_asr_tpu/data/tokenizer.py: CharTokenizer,
SubwordTokenizer, load_tokenizer).

Ids follow the reference configs: pad == blank == 0, bos 1, eos 2, unk 3.
- `CharTokenizer`: the characters in sorted order after the specials.
  Its JSON file is the JAX package's (`{"type": "char", "chars": [...]}`).
- `SubwordTokenizer`: BPE or unigram pieces (the S2S recipes' vocab
  5000) through the HuggingFace `tokenizers` package, imported when a
  subword tokenizer is fitted or loaded; without it those raise
  RuntimeError. Its JSON file is that package's own.
Either package loads the other's `tokenizer_<type>.json`.
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


def _tokenizers():
    try:
        import tokenizers
    except ImportError as e:
        raise RuntimeError("SubwordTokenizer requires the `tokenizers` package; "
                           "use CharTokenizer instead") from e
    return tokenizers


class SubwordTokenizer:
    """BPE or unigram pieces over a Metaspace pre-tokenizer, the specials
    at ids 0 to 3."""

    def __init__(self, tok):
        self._tok = tok

    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 5000,
              model_type: str = "bpe") -> "SubwordTokenizer":
        tk = _tokenizers()
        if model_type == "bpe":
            tok = tk.Tokenizer(tk.models.BPE(unk_token="<unk>"))
            trainer = tk.trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=_SPECIALS)
        elif model_type == "unigram":
            tok = tk.Tokenizer(tk.models.Unigram())
            trainer = tk.trainers.UnigramTrainer(vocab_size=vocab_size,
                                                 special_tokens=_SPECIALS, unk_token="<unk>")
        else:
            raise ValueError(model_type)
        tok.pre_tokenizer = tk.pre_tokenizers.Metaspace()
        tok.decoder = tk.decoders.Metaspace()
        tok.train_from_iterator(corpus, trainer)
        return cls(tok)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids if i >= len(_SPECIALS)]).strip()

    def save(self, path: str) -> None:
        self._tok.save(path)

    @classmethod
    def load(cls, path: str) -> "SubwordTokenizer":
        return cls(_tokenizers().Tokenizer.from_file(path))


def load_tokenizer(path: str):
    """Load either tokenizer type from its JSON file."""
    with open(path, encoding="utf-8") as f:
        head = f.read(4096)
    if '"type": "char"' in head:
        return CharTokenizer.load(path)
    return SubwordTokenizer.load(path)
