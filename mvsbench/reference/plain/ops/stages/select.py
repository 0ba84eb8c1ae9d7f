"""K11's plain version: the initial cost's top-k view selection.

For each pixel, k = min(#{cost < COST_MAX}, top_k), the mean of its k
smallest costs (COST_MAX where k = 0, ``cost.initial_cost_and_selection``:
the top-k sum in ascending order from +0, a true division) and the views
whose cost is <= the k-th smallest; the state's cost map takes the mean
where the pixel is valid, else 1e9, its selections the views where it is
valid.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..cost import initial_cost_and_selection


INVALID_COST = 1e9   # an invalid pixel's cost


def select_rows_plain(costs: torch.Tensor, valid: torch.Tensor, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state's (n,) costs and (n, S) selections of n pixels from their
    (n, S) costs and (n,) validity."""
    mean, selected = initial_cost_and_selection(costs, top_k)
    return (torch.where(valid, mean, INVALID_COST),
            selected & valid[:, None])
