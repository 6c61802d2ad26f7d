"""LR schedules: cosine (llama-style) and WSD (MiniCPM's
warmup-stable-decay).  Twin of ``repro.optimizer.schedules``: each is a
function of the step (an int or a 0-d tensor) that returns an fp32 0-d
tensor, on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_lr(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def wsd_schedule(peak_lr: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, min_ratio: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, long
    constant plateau, fast exponential-ish (here linear) decay tail."""
    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay_prog = torch.clamp((step - warmup_steps - stable_steps) /
                                 max(decay_steps, 1), 0.0, 1.0)
        decay = peak_lr * (1.0 - (1.0 - min_ratio) * decay_prog)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < warmup_steps + stable_steps,
                                       torch.full_like(step, peak_lr), decay))
    return f
