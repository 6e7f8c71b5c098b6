"""The denoiser's model operations per frame (its 28 convs at the padded
shapes) over the profiled frames' wall time, as a share of the bfloat16
peak, in %."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    if "denoise_flops" not in (rec or {}) or not prof.get("window_s"):
        return None
    per_s = rec["denoise_flops"] * prof["units"] / prof["window_s"]
    return 100.0 * per_s / rec["peak_flops"]
