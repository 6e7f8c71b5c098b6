"""Kernels launched per optimiser step (crop and train step), from the
trace taken with CUDA activity alone."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    if "steps" not in (rec or {}) or not prof.get("kernels"):
        return None
    return prof["kernels"] / prof["units"]
