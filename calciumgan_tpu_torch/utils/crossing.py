"""A tensor's bytes handed to the host as a numpy array the caller owns.

A CUDA tensor crosses by one DMA (``copy_(..., non_blocking=True)``) into
page-locked host memory from torch's caching host allocator, in the
tensor's own layout: the host tensor has its shape and strides, and the
copy runs over both as one flat block, so nothing is copied or transposed
on the host afterwards. The block goes back to the allocator's cache when
the last array over it is dropped, and a later crossing reuses it then: an
array a caller keeps is never overwritten. A CPU tensor is handed over as
it lies (a ``.numpy()`` view); nothing crosses.

Every crossing counts ``to_host/bytes``, the bytes handed to the host, and
``to_host/pinned_bytes``, those that crossed by DMA into page-locked
memory (:func:`~calciumgan_tpu_torch.utils.tracing.count`): their ratio is
the share of the bytes that took the pinned path, 0 for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from calciumgan_tpu_torch.utils import tracing


def _flat(t: torch.Tensor) -> torch.Tensor:
    """The memory of a tensor that fills one dense block, as a 1-D view."""
    return t.as_strided((t.numel(),), (1,))


class Crossing:
    """A copy to the host under way; :meth:`wait` gives its array."""

    def __init__(self, host: torch.Tensor,
                 done: Optional[torch.cuda.Event] = None):
        self.host, self.done = host, done

    def wait(self) -> np.ndarray:
        """The host array, once the copy has landed."""
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


def start(tensor: torch.Tensor,
          stream: Optional[torch.cuda.Stream] = None) -> Crossing:
    """Start handing ``tensor`` to the host.

    A CUDA tensor is copied into ``torch.empty_like(tensor, device="cpu",
    pin_memory=True)``, which keeps its strides where its elements fill one
    dense block (one that does not is made contiguous on the device and
    lands contiguous).
    The copy runs on ``stream``, after the work queued so far on the
    tensor's current stream, which the tensor is fenced for
    (``record_stream``); without ``stream``, on the current stream."""
    n = tensor.numel() * tensor.element_size()
    if not tensor.is_cuda:
        tracing.count("to_host", bytes=n, pinned_bytes=0)
        return Crossing(tensor.cpu())
    host = torch.empty_like(tensor, device="cpu", pin_memory=True)
    if host.stride() != tensor.stride():  # not one dense block
        tensor = tensor.contiguous()
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    current = torch.cuda.current_stream(tensor.device)
    if stream is None:
        stream = current
    elif stream != current:
        stream.wait_stream(current)
        tensor.record_stream(stream)
    done = torch.cuda.Event()
    with torch.cuda.stream(stream):
        _flat(host).copy_(_flat(tensor), non_blocking=True)
        done.record(stream)
    tracing.count("to_host", bytes=n, pinned_bytes=n)
    return Crossing(host, done)


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` on the host: :func:`start` on the current stream, waited
    for."""
    return start(tensor).wait()
