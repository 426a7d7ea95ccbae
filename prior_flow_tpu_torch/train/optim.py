"""Learning-rate schedule, global-norm clip and AdamW of the reference
recipe (counterpart of ``prior_flow_tpu/train/optim.py``).

The schedule is optax's ``join_schedules`` of two linear pieces, step for
step; torch's ``OneCycleLR`` puts its phase boundaries one step elsewhere,
so it is not used. The clip is optax's ``clip_by_global_norm`` rule,
g * min(1, clip / ||g||) with no epsilon (``clip_grad_norm_`` adds 1e-6).
AdamW is torch's, with optax's defaults: eps outside the square root and
decoupled decay on every parameter; update k runs at ``schedule(k)``.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch


def one_cycle_linear(max_lr: float, total_steps: int, pct_start: float = 0.05,
                     div_factor: float = 25.0,
                     final_div_factor: float = 1e4) -> Callable[[int], float]:
    """step -> learning rate: linear warm-up from max_lr/div_factor to
    max_lr over warm = max(int(pct_start * total_steps), 1) steps, then
    linear decay to max_lr/(div_factor*final_div_factor) at total_steps
    (``prior_flow_tpu/train/optim.py:19-28``)."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warm = max(int(pct_start * total_steps), 1)
    decay = total_steps - warm

    def linear(init: float, end: float, steps: int, count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def schedule(step: int) -> float:
        if step < warm:
            return linear(initial, max_lr, warm, step)
        return linear(max_lr, final, decay, step - warm)

    return schedule


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax's
    ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor,
                         clip: float) -> None:
    """Scale ``grads`` in place by min(1, clip / norm); a zero norm leaves
    them as they are. No host synchronisation."""
    torch._foreach_mul_(grads, torch.clamp(clip / norm, max=1.0))


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, wdecay: float = 1e-4,
                   epsilon: float = 1e-8, pct_start: float = 0.05):
    """AdamW plus the OneCycle(linear) schedule over num_steps + 100 steps
    (``prior_flow_tpu/train/optim.py:31-41``). Returns (optimizer,
    schedule); the caller sets each step's rate from the schedule."""
    schedule = one_cycle_linear(lr, num_steps + 100, pct_start=pct_start)
    optimizer = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                                  eps=epsilon, weight_decay=wdecay)
    return optimizer, schedule
