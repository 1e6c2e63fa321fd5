"""What every architecture's work counts share: the card's peaks, the
least time of a piece of work, causal attention's pairs.

Each architecture counts its own operations and bytes from shapes
(``architectures/<name>.py``), a frozen yardstick in the manner of
``repro_torch/launch/dryrun.py``'s ``model_flops`` and
``analytic_hbm_bytes``, from the benchmark's own configuration file
rather than from ``ModelConfig.param_count``.

Peaks: one H100 SXM, NVIDIA's data sheet, dense bf16 989 TFLOP/s, HBM3
3.35 TB/s, at the full 700 W power limit.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16_BYTES = 2


def causal_pairs(n: int, window=None) -> int:
    """(query, key) pairs of causal attention over n tokens, within
    ``window`` keys of each query if given."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    w = window
    return w * (w + 1) // 2 + (n - w) * w


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)
