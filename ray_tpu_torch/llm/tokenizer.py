"""Tokenizers for the LLM engine (port of ray_tpu/llm/tokenizer.py).

A dependency-free byte-level tokenizer, and an HF loader for a local
tokenizer directory that imports ``transformers`` only when asked for.
"""

from __future__ import annotations


class ByteTokenizer:
    """Byte-level: ids 0..255 are bytes; specials above."""

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 259:
            raise ValueError("ByteTokenizer needs vocab_size >= 259")
        self.vocab_size = vocab_size
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = []
        for m in messages:
            parts.append(f"<|{m['role']}|>\n{m['content']}\n")
        parts.append("<|assistant|>\n")
        return "".join(parts)


class HFTokenizer:
    """Wraps a locally available HF tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)
        self.vocab_size = self._tok.vocab_size
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.pad_id = self._tok.pad_token_id or self.eos_id

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict]) -> str:
        try:
            return self._tok.apply_chat_template(messages, tokenize=False,
                                                 add_generation_prompt=True)
        except Exception:
            return ByteTokenizer.apply_chat_template(self, messages)  # type: ignore[arg-type]


def get_tokenizer(spec: str):
    if spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
