"""A small cache of tensors derived from other tensors (packed weights,
packed face tables), so that a kernel's wrapper builds them once."""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Tuple

import torch


class DerivedCache:
    """The most recent ``entries`` tensors derived from source tensors.

    An entry is found by the source's identity and version counter, so an
    in-place update of the source misses, and it holds the source, so the
    source's storage cannot pass to another tensor while it is cached.
    """

    def __init__(self, entries: int):
        self.entries = entries
        self._items: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = OrderedDict()

    def get(self, src: torch.Tensor, key: tuple,
            derive: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The tensor ``derive()`` made for ``src`` and ``key``; made now on
        a miss."""
        key = (id(src), src._version) + key
        hit = self._items.get(key)
        if hit is not None and hit[0] is src:
            self._items.move_to_end(key)
            return hit[1]
        out = derive()
        self._items[key] = (src, out)
        if len(self._items) > self.entries:
            self._items.popitem(last=False)
        return out

    def __len__(self) -> int:
        return len(self._items)
