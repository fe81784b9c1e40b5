"""Device time of the fused verify stage kernel (``verify_stage_kernel``,
csrc/verify_stage.cu) in the traced window, in microseconds per million
reads fed."""


def read(run):
    tr = run["trace"]
    if run["mode"] != "se" or tr is None or not run["n"]:
        return None
    ns = sum(v for k, v in tr["device_ns_by_name"].items()
             if "verify_stage" in k)
    if not ns:
        return None
    return ns / 1e3 / (run["n"] / 1e6)
