"""Three times the forward operations of a step (batch x frames x the 28
convs at the crop) over the profiled steps' wall time, as a share of the
bfloat16 peak, in %."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    if "step_flops" not in (rec or {}) or not prof.get("window_s"):
        return None
    return 100.0 * rec["step_flops"] * prof["units"] / prof["window_s"] / rec["peak_flops"]
