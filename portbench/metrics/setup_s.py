"""setup_s: from the start of the process to the start of the window:
imports, the CUDA context, the seeded frames, the program's build on a
checkout's first run, and the warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
