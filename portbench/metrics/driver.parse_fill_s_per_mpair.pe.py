"""The PE driver's ``host_parse.fill`` spans (the FASTQ stream's reads and
the parse buffer's growth and trim, ``FgetsLines.fill`` and
``take_buffer``), in seconds per million pairs fed."""


def read(run):
    s = run["spans"].get("host_parse.fill")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
