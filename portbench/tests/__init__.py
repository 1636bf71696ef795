"""CPU tests of the benchmark; card tests are marked ``cuda`` and skip here."""
