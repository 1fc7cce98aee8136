"""The IVF index, its dispatch model and its search programs."""
