"""Plain references of the configurations' ops, one file per op."""
