"""Masked segment reductions (port of `gemnet_pytorch_tpu/ops/segment.py`).

Edge->atom and atom->molecule sums over in-bounds ids with mask-zeroed
sources (the padding convention of `data/padding.py`). These are XLA
segment sums in the JAX package, not Pallas kernels; here they are
`index_add`, accumulated in fp32.
"""

from __future__ import annotations

import torch


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.to(like.dtype).reshape((-1,) + (1,) * (like.ndim - 1))


def masked_segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Segment sum with padded rows contributing exact zeros (fp32 result)."""
    data = data.float()
    if mask is not None:
        data = data * _expand(mask, data)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def masked_segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Segment mean over real rows only (count from mask, clamped to >= 1)."""
    total = masked_segment_sum(data, segment_ids, num_segments, mask)
    ones = (mask.to(total.dtype) if mask is not None
            else total.new_ones(data.shape[0]))
    counts = total.new_zeros(num_segments).index_add(0, segment_ids, ones)
    counts = torch.clamp_min(counts, 1.0)
    return total / counts.reshape((-1,) + (1,) * (data.ndim - 1))
