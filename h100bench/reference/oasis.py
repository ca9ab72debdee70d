"""Plain PyTorch reference of OASIS AR(1) spike inference (Friedrich, Zhou &
Paninski, PLoS Comput Biol 2017, Algorithm 1, with a minimum spike size and
no sparsity penalty), written from the float64 golden model
``calciumgan_tpu/ops/oasis_ref.py`` (commit 8a6615f).

The golden model walks one trace: push each frame as a pool ``(v, w, len)``
and, while the top pool's height ``v/w`` is below ``g**len_prev *
(v/w)_prev + s_min``, merge it into its left neighbour; then ``c`` is each
pool's ``max(v/w, 0) * g**k`` and ``s[t] = c[t] - g*c[t-1]``. Here every
trace is a lane of one batch: an iteration merges in a lane whose top
violates the order and pushes the next frame in the others, in the golden
model's order of operations, until no lane has work (an iteration of a
lane without work writes back what it read). Lanes are independent, so any
subset of rows gives those rows' result. ``dtype`` float64 is the
reference; float32 is the control.

On a GPU the iterations replay as a CUDA graph of ``_CHUNK`` iterations:
a trace of T frames takes up to 2T of them, each a few dozen small
operations, which launched one by one would take longer than the
benchmark's window at 16,384 frames.
"""

from __future__ import annotations

import torch

_CHUNK = 64  # iterations between two looks at whether a lane has work


def spikes(traces: torch.Tensor, g: float, s_min: float, threshold: float,
           dtype=torch.float64) -> torch.Tensor:
    """Boolean spikes of ``(N, T)`` traces, on their device."""
    y = traces.to(dtype)
    N, T = y.shape
    dev = y.device
    gt = torch.tensor(g, dtype=dtype, device=dev)
    # each lane's pools: (v, w, length) in slots 0..p, in ``dtype``
    pools = torch.zeros((N, T, 3), dtype=dtype, device=dev)
    pools[:, 0, 0], pools[:, 0, 1], pools[:, 0, 2] = y[:, 0], 1.0, 1.0
    rows = torch.arange(N, device=dev)
    p = torch.zeros(N, dtype=torch.long, device=dev)  # top pool
    t = torch.ones(N, dtype=torch.long, device=dev)   # next frame
    one = torch.ones(N, dtype=dtype, device=dev)

    def decide():
        q = (p - 1).clamp_min(0)
        top, below = pools[rows, p], pools[rows, q]
        gl = gt ** below[:, 2]
        viol = (p > 0) & (top[:, 0] / top[:, 1]
                          < gl * (below[:, 0] / below[:, 1]) + s_min)
        return q, top, below, gl, viol, ~viol & (t < T)

    def iteration():
        q, top, below, gl, viol, push = decide()
        merged = torch.stack([below[:, 0] + gl * top[:, 0],
                              below[:, 1] + gl * gl * top[:, 1],
                              below[:, 2] + top[:, 2]], 1)
        pools[rows, q] = torch.where(viol[:, None], merged, below)
        nxt = (p + 1).clamp_max(T - 1)
        pushed = torch.stack([y[rows, t.clamp_max(T - 1)], one, one], 1)
        pools[rows, nxt] = torch.where(push[:, None], pushed,
                                       pools[rows, nxt])
        p.add_(push.long() - viol.long())
        t.add_(push.long())

    def pending() -> bool:
        *_, viol, push = decide()
        return bool((viol | push).any())

    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            iteration()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(_CHUNK):
                iteration()
        while pending():
            graph.replay()
    else:
        while pending():
            for _ in range(_CHUNK):
                iteration()

    v, w, ln = pools.unbind(2)
    idx = torch.arange(T, device=dev)
    valid = idx[None, :] < (p + 1)[:, None]
    lengths = torch.where(valid, ln.long(), 0)
    starts = torch.cumsum(lengths, 1) - lengths
    starts = torch.where(valid, starts, T)
    pool = torch.searchsorted(starts, idx.expand(N, T).contiguous(),
                              right=True) - 1
    h = torch.clamp_min(v / torch.where(valid, w, 1.0), 0.0)
    k = idx[None, :] - starts.gather(1, pool)
    c = h.gather(1, pool) * gt ** k.to(dtype)
    s = torch.cat([torch.zeros_like(c[:, :1]), c[:, 1:] - gt * c[:, :-1]],
                  dim=1)
    return s > threshold
