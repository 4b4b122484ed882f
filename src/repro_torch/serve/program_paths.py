"""The speculative commit as a recorded CPM program (a port of
``repro.serve.program_paths``).

Per verify round the engine appends the round's predictions at each row's
live end and rolls the §4.2 length register back to the accepted prefix:
``insert(used, preds) -> truncate(used + emit_n)`` on the token buffer.
The stream is scheduled *cost-aware* (the device geometry is known
here): on the cuda backend the launch/byte model
(``repro_torch.cpm.program.costmodel``, calibrated on the card) decides
per commit whether the pair runs as ONE ``fused_stream`` launch or as
per-op dispatch (the ``insert`` as one ``shift_range`` launch over
every row's own bounds); on the reference backend no decision is made.
Either way the instructions — and the committed tokens — are identical.
"""

from __future__ import annotations

import torch

from repro_torch.cpm import CPMArray, CPMProgram
from repro_torch.cpm.program import schedule


def record_commit_program(buf, used, preds, emit_n,
                          backend: str = "reference"):
    """Build (not run) the commit stream of one verify round; returns
    ``(device, plan)``, the plan's group ``fused`` or ``eager`` as the
    backend's cost model decides."""
    used = used.to(torch.int32)
    dev = CPMArray(buf, used, backend=backend)
    prog = CPMProgram() \
        .append("insert", pos=used, values=preds) \
        .append("truncate", new_len=used + emit_n)
    return dev, schedule(prog, device=dev, backend=backend)


def commit_tokens(buf, used, preds, emit_n, backend: str = "reference"):
    """Commit one speculative round into the token buffer.

    ``buf``: (B, cap) tokens; ``used``: (B,) live lengths; ``preds``:
    (B, draft_len) teacher-forced predictions; ``emit_n``: (B,) accepted
    counts clipped to the budget.  Returns ``(new_buf, new_used)``."""
    dev, plan = record_commit_program(buf, used, preds, emit_n,
                                      backend=backend)
    out, _ = plan.run(dev, backend=backend)
    return out.data, out.used_len
