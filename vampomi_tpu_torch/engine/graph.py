"""An exact linear iteration replayed as one CUDA graph.

From the iteration on whose work stops changing shape (damped, the EM
update on if it ever is), a linear fit under the eigen factor repeats the
same launches: EM and the merge, the denoiser, the two-column pass over X,
the factor's N x N step, the pass back, the error measures and the stack
of O(1) outputs the loop fetches, some 150 kernels of a few microseconds
each.  Launched one by one, they leave the card idle while the host
enqueues them.  `IterationGraph` runs that iteration once eagerly on the
card's graph stream, which loads every kernel and cuBLAS's workspace for
that stream; captures it the next time, into a memory pool of the graph's
own; and from then on replays it, one launch an iteration.  The graph
stream is one a card for the process, as torch.cuda.graph keeps one
capture stream: the caching allocator's blocks for it and cuBLAS's
workspace outlive a fit, and fits on one card capture one at a time.

The graph holds the iteration's state in buffers of its own: a replay
copies the state in, runs the iteration on the copy and writes the next
state back into the buffers.  Every tensor a replay returns is rewritten by
the next replay.  A replay counts the passes over X and the kernel
launches its capture counted (ops/operator.py count_passes); the capture
itself, which runs nothing, counts none.
"""

from __future__ import annotations

import torch

from ..ops.operator import count_passes, pass_counts
from ..utils.telemetry import span

_STREAMS: dict = {}  # the graph stream of each card


def _stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


class IterationGraph:
    """The steady iterations of one fit on a card.  `replays` counts the
    iterations that ran as a replay."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = _stream(device)
        self.graph = None
        self.warm = False
        self.replays = 0

    def run(self, step, state: tuple) -> tuple:
        """One iteration of `step(*state) -> (next state, outputs)`, the
        state a tuple of tensors and the outputs a dict of them: (the state
        it read, its next state, its outputs).  After the capture `state`
        must be the next state the last call returned, which the graph
        holds; the graph replays then, in a `solve` span, and the capture
        is timed by a `graph_capture` span."""
        if not self.warm:
            self.warm = True
            main = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                nxt, out = step(*state)
            main.wait_stream(self.stream)
            return state, nxt, out
        if self.graph is None:
            with span("graph_capture"):
                self._capture(step, state)
        elif any(a is not b for a, b in zip(state, self._next)):
            raise RuntimeError("IterationGraph: the state is not the graph's own")
        with span("solve"), torch.cuda.device(self.device):
            self.graph.replay()
        count_passes(self._counted)
        self.replays += 1
        return self._in, self._next, self._out

    def _capture(self, step, state: tuple) -> None:
        self._next = tuple(t.clone() for t in state)
        before = pass_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            # thread_local: the IO thread may wait on its copies meanwhile
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._in = tuple(t.clone() for t in self._next)
                nxt, self._out = step(*self._in)
                for buf, t in zip(self._next, nxt):
                    buf.copy_(t)
            finally:
                graph.capture_end()
        self._counted = [a - b for a, b in zip(pass_counts(), before)]
        count_passes([-d for d in self._counted])
        self.graph = graph
