"""Program spans: named ranges of the port's own work in a ``torch.profiler``
trace.

``with span("di.sparse.tables"): ...`` records, while a profiler records,
one ``cpu_op`` event of that name on the calling thread, on the profiler's
clock and nested with the ATen operators it calls
(``torch._C._profiler._RecordFunctionFast``, ~0.7 us a span on the CPU).
With no profiler it returns one shared ``nullcontext`` after a check of
the profiler's flag: the span costs about a tenth of a microsecond and
records nothing. A span adds no launch, no sync and no tensor.

Every name starts with ``di.``, so a reader tells the program's spans
from ATen's operators. The names (where the span opens):

- layers, one each where the program calls the layer's work:
  ``di.voxelize`` (``ops/voxelize.py::voxelize_batched``),
  ``di.image_stage`` (``ops/images.py::prepare_images``),
  ``di.img_branch`` (the image backbone and FPN), ``di.sparse_encoder``,
  ``di.bev`` (SECOND and SECONDFPN), ``di.mmri`` with ``di.mmri.i2p`` and
  ``di.mmri.p2i`` inside it (``models/mmri_encoder.py``), ``di.ppneck``,
  ``di.decoder`` (``models/detector.py``) and ``di.get_bboxes``
  (``inference.py``); inside ``di.sparse_encoder``, ``di.sparse.tables``
  around each neighbour-table build (``models/sparse_encoder.py``);
- the train step's phases (``train/step.py``): ``di.train.forward``,
  ``di.train.targets`` (with ``di.train.matching`` around the LAP,
  ``targets/assign.py``), ``di.train.loss``, ``di.train.backward``,
  ``di.train.grad_norm`` and ``di.train.update``;
- ``di.sync.<site>`` around each call that waits for the device (a copy
  to or from pageable host memory, ``.item()``, a boolean mask's
  ``nonzero``): one span a sync, so the spans' count is the syncs'.

``tools/analyze_trace.py`` prints each span's count, host ms, device ms
and idle ms.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` while a profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


def grad_span(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t``; while a profiler records, also a span named ``name`` around
    the backward of the operation that made ``t``, on the thread that runs
    it (the autograd engine's, on a card): a boolean mask's backward waits
    for the device as its forward does."""
    node = t.grad_fn
    if node is None or not _profiler._is_profiler_enabled:
        return t
    opened = []

    def enter(_grad_outputs):
        rf = _RecordFunctionFast(name)
        rf.__enter__()
        opened.append(rf)

    def leave(_grad_inputs, _grad_outputs):
        opened.pop().__exit__(None, None, None)

    node.register_prehook(enter)
    node.register_hook(leave)
    return t
