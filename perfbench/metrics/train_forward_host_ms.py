"""Host time inside the program's ``train.forward`` span, median per
``train.step`` over the records the program kept of the window
(ai_path_tracer_denoiser_tpu_torch/utils/timers.py), in ms.  Silent where no
kernel was traced (as ``train_launches``), or where the program keeps no
spans."""
import statistics


def read(rec):
    prof = (rec or {}).get("profile") or {}
    if "steps" not in (rec or {}) or not prof.get("kernels"):
        return None
    from ai_path_tracer_denoiser_tpu_torch.utils import timers
    records = getattr(timers, "records", None)
    ns = [r["spans"].get("train.forward", 0) for r in (records("train.step") if records else ())]
    return 1e-6 * statistics.median(ns) if ns else None
