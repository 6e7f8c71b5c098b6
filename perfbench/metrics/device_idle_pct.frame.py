"""Share of the profiled frames' wall span in which no kernel, copy or
fill ran on the device (union of their intervals, not their sum), in %."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    if "frames" not in (rec or {}) or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
