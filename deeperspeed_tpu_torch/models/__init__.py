"""The model families of the port: GPT-NeoX, GPT-2 and BERT."""

from .gpt2 import GPT2, GPT2Config

__all__ = ["GPT2", "GPT2Config"]
