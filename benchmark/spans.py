"""What the program's own spans read over a traced window.

The port records spans (`go_jpeg2000_tpu_torch.utils.metrics`,
`counters.span`) only while a torch profiler records, so in a run of the
benchmark their totals are the traced window's.  `per_call` divides one
total by the calls of the entry point's root span.  It returns None where
the program has no spans, or the root or the span was never recorded.
"""
from __future__ import annotations

from typing import Optional


def per_call(name: str, field: str, root: str = "enc.batch"
             ) -> Optional[float]:
    """`field` ("incl_ns" or "self_ns") of the span `name` in the window,
    over the root span's calls."""
    from go_jpeg2000_tpu_torch.utils.metrics import counters
    read = getattr(counters, "spans", None)
    if read is None:
        return None
    spans = read()
    calls = spans.get(root, {}).get("calls", 0)
    if not calls or name not in spans:
        return None
    return spans[name][field] / calls
