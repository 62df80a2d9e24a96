"""Text: tokenization and the inverted index behind filters."""

from weaviate_tpu_torch.text.tokenizer import tokenize
from weaviate_tpu_torch.text.inverted import InvertedIndex

__all__ = ["tokenize", "InvertedIndex"]
