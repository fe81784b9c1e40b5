"""Seconds from the process's start to the window's start, less the making
of the synthetic genome and read pool (a user mapping a library against a
prebuilt index pays neither)."""


def read(run):
    return run["setup_s"]
