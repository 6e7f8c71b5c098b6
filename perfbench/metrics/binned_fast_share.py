"""Share of the binned mesh route's calls inside ``render.frame`` that took
the packed pipeline (the program's ``binned.fast`` counter) rather than
falling back to the per-ray traversal (``binned.fallback``), summed over the
records the program kept of the window
(ai_path_tracer_denoiser_tpu_torch/utils/timers.py), in %.  Silent where no
card was timed, where the program keeps no spans, or where no frame took
the binned route."""


def read(rec):
    if not rec or rec.get("render_ms") is None:
        return None
    from ai_path_tracer_denoiser_tpu_torch.utils import timers
    records = getattr(timers, "records", None)
    frames = records("render.frame") if records else []
    fast = sum(r["counts"].get("binned.fast", 0) for r in frames)
    calls = fast + sum(r["counts"].get("binned.fallback", 0) for r in frames)
    return 100.0 * fast / calls if calls else None
