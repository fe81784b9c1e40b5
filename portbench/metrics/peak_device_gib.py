"""The card's peak reserved memory (the caching allocator's
``max_memory_reserved``) over the whole run, set-up included, in GiB."""


def read(run):
    if not run["peak_bytes"]:
        return None
    return run["peak_bytes"] / 2 ** 30
