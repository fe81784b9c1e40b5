"""The PE driver's FASTQ copy amplification over the window: bytes written
into parse buffers (``parse.buffer_bytes``: each buffer
``FgetsLines.fill`` makes, each leftover ``take_buffer`` carries) per byte
read from the two mates' streams (``parse.stream_bytes``).  Nothing where
the program keeps no such counters."""


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "counters"):
        return None
    got = perf.counters()
    stream = got.get("parse.stream_bytes", 0)
    if not stream or "parse.buffer_bytes" not in got:
        return None
    return got["parse.buffer_bytes"] / stream
