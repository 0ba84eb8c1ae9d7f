"""Multi-hypothesis joint view selection (reference: APD.cu:1318-1386).

Given the 8 candidate cost vectors of a pixel, estimate per-view sampling
probabilities (quality from candidate costs x prior votes from neighbors'
selected views), then draw 15 Monte-Carlo samples from the CDF to produce
integer view weights. The clock-seeded curand stream is replaced by
uniform draws that the caller passes in (from a torch.Generator, or the
same draws the JAX package used, in the parity tests).
"""

from __future__ import annotations

from typing import Tuple

import torch

NUM_SAMPLES = 15
PRIOR_SELECTED = 0.9
PRIOR_UNSELECTED = 0.1


# The selection with every sum in a fixed order, as K3's and K7's plain
# versions take it (stages/strong.py, stages/weak_sweep.py): torch's
# ``.sum`` and ``cumsum`` reduce in a device-dependent order.

def selection_thresholds(iteration) -> Tuple[float, float]:
    """(cost threshold 0.8 exp(-it^2 / 90), fallback probability
    exp(-threshold^2 / 0.32)) as float32 values, computed once on the host
    with the torch ops of `sampling_probabilities`."""
    it = torch.tensor(float(iteration), dtype=torch.float32)
    threshold = 0.8 * torch.exp(it * it / -90.0)
    fallback = torch.exp(threshold * threshold / -0.32)
    return float(threshold), float(fallback)


def ordered_priors(neighbor_selected: torch.Tensor,
                   neighbor_valid: torch.Tensor) -> torch.Tensor:
    """`view_selection_priors`, the K neighbours' votes added in order from
    0: (B, K, S), (B, K) -> (B, S)."""
    votes = torch.where(neighbor_selected, PRIOR_SELECTED, PRIOR_UNSELECTED)
    valid = neighbor_valid.to(votes.dtype)
    priors = torch.zeros_like(votes[:, 0])
    for k in range(votes.shape[1]):
        priors = priors + votes[:, k] * valid[:, k, None]
    return priors


def ordered_probabilities(cost_array: torch.Tensor, priors: torch.Tensor,
                          threshold: float, fallback: float) -> torch.Tensor:
    """`sampling_probabilities` from the (B, C, S) candidate costs at the
    thresholds of `selection_thresholds`: the good costs' weights added in
    candidate order from 0, every division a true one."""
    scale = torch.tensor(-0.18, dtype=torch.float32,
                         device=cost_array.device)
    good = cost_array < threshold
    count = good.sum(dim=-2)
    terms = torch.where(good, torch.exp((cost_array * cost_array) / scale),
                        0.0)
    tmpw = torch.zeros_like(priors)
    for c in range(cost_array.shape[1]):
        tmpw = tmpw + terms[:, c]
    count_false = (cost_array > 1.2).sum(dim=-2)
    many_good = (count > 2) & (count_false < 3)
    few_bad = count_false < 3
    probs = torch.where(many_good, tmpw / torch.clamp(count, min=1),
                        torch.where(few_bad, fallback, 0.0))
    return probs * priors


def ordered_view_weights(r: torch.Tensor, probs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """`monte_carlo_view_weights` with the CDF as a running sum in view
    order s = 0 .. S-1 from 0, its last entry the total."""
    S = probs.shape[-1]
    run = torch.zeros_like(probs[:, 0])
    raw = []
    for s in range(S):
        run = run + probs[:, s]
        raw.append(run)
    total = run[:, None]
    cdf = torch.stack(raw, -1) / torch.clamp(total, min=1e-30)
    idx = (cdf[:, None, :] <= r[..., None]).sum(-1)         # (B, NUM_SAMPLES)
    onehot = idx[..., None] == torch.arange(S, device=probs.device)
    vw = onehot.sum(dim=1).to(torch.float32)
    vw = torch.where(total > 0, vw, 0.0)
    # integer counts: their sum is exact in any order
    return vw, vw > 0, vw.sum(-1)
