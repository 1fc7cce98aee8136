"""Native (C++) shard file I/O, loaded with ctypes."""
