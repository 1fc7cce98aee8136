"""Posting layout, vector store, shard files and persistence.

The shard container keeps the reference's byte layout (header / centroid
index / aligned cluster blocks), so selective per-centroid reads, id
validation and corruption -> error carry over; a C++ reader / writer
(``storage/native``) is the native I/O path when g++ can build it.
"""

from .layout import PostingLayout, build_layout
from .shard_format import (
    Shard,
    ShardFormatError,
    ShardHeader,
    load_shard_from_disk,
    read_centroid_vectors,
    read_shard_header,
    save_shard,
)
from .vector_store import Vector, VectorStore

__all__ = [
    "Vector",
    "VectorStore",
    "PostingLayout",
    "build_layout",
    "Shard",
    "ShardHeader",
    "save_shard",
    "read_shard_header",
    "read_centroid_vectors",
    "load_shard_from_disk",
    "ShardFormatError",
]
