"""Kernels launched inside the render span per profiled frame."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    span = prof.get("spans", {}).get("render")
    if not span or not prof.get("units"):
        return None
    return span["kernels"] / prof["units"]
