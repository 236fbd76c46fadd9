"""Seconds the program spent capturing its CUDA graphs in set-up (its
compile.programs.seconds counter at the window's start)."""


def read(run):
    return run["capture_s"]
