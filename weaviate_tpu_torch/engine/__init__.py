"""Vector engine: the device-resident stores (plain and quantized) and the
flat index."""

from weaviate_tpu_torch.engine.flat import FlatIndex
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore
from weaviate_tpu_torch.engine.store import DeviceVectorStore

__all__ = ["DeviceVectorStore", "FlatIndex", "QuantizedVectorStore"]
