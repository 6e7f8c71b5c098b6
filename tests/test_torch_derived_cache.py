"""The port's cache of derived tensors (utils/derived_cache.py), which the
conv kernels' packed weights and K4's packed face table share."""
import torch

from ai_path_tracer_denoiser_tpu_torch.utils.derived_cache import DerivedCache


def test_hit_miss_and_eviction():
    cache = DerivedCache(2)
    made = []

    def derive(t):
        def make():
            made.append(t)
            return t * 2
        return make

    a, b, c = torch.ones(3), torch.zeros(3), torch.full((3,), 3.0)
    first = cache.get(a, (), derive(a))
    assert cache.get(a, (), derive(a)) is first and len(made) == 1
    # another key of one source is another entry
    assert cache.get(a, ("other",), derive(a)) is not first and len(made) == 2
    # a third entry evicts the least recently used, (a, ("other",))
    cache.get(a, (), derive(a))
    cache.get(b, (), derive(b))
    assert len(cache) == 2 and len(made) == 3
    assert cache.get(a, (), derive(a)) is first
    cache.get(c, (), derive(c))                 # evicts b
    cache.get(b, (), derive(b))
    assert len(made) == 5


def test_in_place_update_misses():
    cache = DerivedCache(4)
    w = torch.ones(4)
    first = cache.get(w, (), lambda: w * 2)
    w.add_(1.0)
    second = cache.get(w, (), lambda: w * 2)
    assert second is not first and torch.equal(second, torch.full((4,), 4.0))
