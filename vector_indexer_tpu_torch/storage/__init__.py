"""Posting layout, vector store, shard files and persistence."""
