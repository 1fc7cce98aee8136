"""Distance, selection and kernel operators (K1-K4 with their plain versions)."""
