"""The MASIM-style multi-bank stream packer (a port of
``repro.cpm.pool.scheduler``).

:meth:`MultiBankScheduler.submit` queues one session's instruction
stream against its (bank, slot) placement; :meth:`flush` packs every
queued stream of a bank into one *batched* ``CPMProgram`` over the
bank's ``(slots, width)`` device — per-slot operands scattered into
per-row operand tensors, idle rows given identity operands — and runs it
once per bank.  On a ``cuda`` bank a fusable template (the serving
commit's ``insert -> truncate``) is therefore ONE ``fused_stream``
kernel launch per bank per flush, however many sessions committed.

Streams packed into one flush must share a *template* — the same op
sequence with the same static operands; mixed templates raise.  Idle-row
identity operands exist for ``insert`` (append at the row's own tail —
writes land beyond ``used_len``), ``truncate`` (keep the row's current
length) and ``shift`` (empty range).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import torch

from repro_torch.obs import metrics as _obs_metrics

from .._tensor import asarray
from ..array import CPMArray
from ..program import CPMProgram, schedule
from .bank import CPMBank

# launch accounting, one label (sched="<id>") per scheduler instance
_SCHED_IDS = itertools.count()
_SCHED_FAMILIES = {
    "flushes": _obs_metrics.counter(
        "repro_sched_flushes_total", "multi-bank flush calls", ("sched",)),
    "streams_packed": _obs_metrics.counter(
        "repro_sched_streams_packed_total",
        "per-session streams packed into batched launches", ("sched",)),
    "bank_launches": _obs_metrics.counter(
        "repro_sched_bank_launches_total",
        "batched program launches across banks", ("sched",)),
}

#: operand names treated as dynamic (per-slot) per op, with their rank;
#: everything else in an instruction is static and must agree across the
#: packed streams
_DYNAMIC: dict[str, dict[str, int]] = {
    "insert": {"pos": 0, "values": 1},
    "truncate": {"new_len": 0},
    "shift": {"start": 0, "end": 0},
    "compare": {"datum": 0},
    "delete": {"pos": 0},
}

#: ops with a per-row identity default for rows that did not submit
_HAS_IDENTITY = frozenset({"insert", "truncate", "shift"})


@dataclasses.dataclass(frozen=True)
class _Pending:
    slot: int
    ops: tuple[tuple[str, dict[str, Any]], ...]

    def template(self):
        """(op, sorted static operand items) per instruction — the SPMD
        signature two streams must share to pack into one launch."""
        sig = []
        for op, operands in self.ops:
            dyn = _DYNAMIC.get(op, {})
            statics = []
            for k, v in operands.items():
                if k in dyn:
                    continue
                if not isinstance(v, (int, float, str, bool, type(None),
                                      tuple)):
                    raise TypeError(
                        f"{op}.{k}: static operands must be primitives, "
                        f"got {type(v).__name__} (per-slot values go in "
                        f"the dynamic operands: {sorted(dyn)})")
                statics.append((k, v))
            sig.append((op, tuple(sorted(statics))))
        return tuple(sig)


class MultiBankScheduler:
    """Packs per-session streams into one batched launch per bank."""

    flushes = _obs_metrics.series_property("flushes")
    streams_packed = _obs_metrics.series_property("streams_packed")
    bank_launches = _obs_metrics.series_property("bank_launches")

    def __init__(self, banks: list[CPMBank]):
        self.banks = banks
        self._queues: list[list[_Pending]] = [[] for _ in banks]
        label = str(next(_SCHED_IDS))
        self._obs_series = {
            k: fam.labels(sched=label) for k, fam in _SCHED_FAMILIES.items()}

    def submit(self, bank: int, slot: int, ops) -> None:
        """Queue one session's stream for ``(bank, slot)``; ``ops`` is a
        sequence of ``(op_name, operand_dict)``."""
        b = self.banks[bank]
        if not 0 <= slot < b.slots:
            raise IndexError(f"slot {slot} out of range for bank {bank} "
                             f"({b.slots} slots)")
        self._queues[bank].append(
            _Pending(slot, tuple((op, dict(d)) for op, d in ops)))

    def flush(self) -> dict:
        """Execute every queued stream: one batched program run per bank.
        Returns ``{"banks": touched, "streams": packed}``."""
        touched = streams = 0
        for bank_id, queue in enumerate(self._queues):
            if not queue:
                continue
            self._run_bank(bank_id, queue)
            touched += 1
            streams += len(queue)
            queue.clear()
        self.flushes += 1
        self.streams_packed += streams
        self.bank_launches += touched
        return {"banks": touched, "streams": streams}

    # -- one bank: scatter operands, run once -------------------------------
    def _run_bank(self, bank_id: int, queue: list[_Pending]) -> None:
        bank = self.banks[bank_id]
        template = queue[0].template()
        for p in queue[1:]:
            if p.template() != template:
                raise ValueError(
                    f"bank {bank_id}: streams with different templates "
                    f"cannot pack into one launch ({p.template()} vs "
                    f"{template}); flush between template changes")
        slots_seen = set()
        for p in queue:
            if p.slot in slots_seen:
                raise ValueError(f"bank {bank_id}: two streams target slot "
                                 f"{p.slot} in one flush")
            slots_seen.add(p.slot)

        dev = bank.data.device
        idx = torch.tensor([p.slot for p in queue], dtype=torch.long,
                           device=dev)
        full = len(queue) == bank.slots
        prog = CPMProgram()
        for i, (op, statics) in enumerate(template):
            batched = {}
            for name, rank in _DYNAMIC.get(op, {}).items():
                vals = [p.ops[i][1].get(name) for p in queue]
                if all(v is None for v in vals):
                    continue
                if any(v is None for v in vals):
                    raise ValueError(
                        f"bank {bank_id}: {op}.{name} is bound by only "
                        f"some of the packed streams; every stream in a "
                        f"flush must supply the same dynamic operands")
                shape = (-1,) if rank else ()
                stacked = torch.stack([asarray(v, device=dev).reshape(shape)
                                       for v in vals])
                if full:                 # every row participates: the base
                    base = torch.zeros(  # values are all overwritten
                        (bank.slots,) + tuple(stacked.shape[1:]),
                        dtype=stacked.dtype, device=dev)
                else:
                    base = self._identity_operand(bank, op, name,
                                                  stacked).clone()
                base[idx] = stacked.to(base.dtype)
                batched[name] = base
            prog.append(op, **dict(statics), **batched)
        out, _ = schedule(prog).run(bank.device(), backend=bank.backend)
        bank.update(out)

    def _identity_operand(self, bank: CPMBank, op: str, name: str, stacked):
        """Per-row default that makes ``op`` a no-op within idle rows' live
        regions."""
        if op not in _HAS_IDENTITY:
            raise ValueError(
                f"op {op!r} has no idle-row identity operand; submit a "
                f"stream for every slot of the bank or split the flush")
        r, dev = bank.slots, bank.data.device
        if op == "insert":
            if name == "pos":
                return bank.lens                    # append into dead space
            return torch.zeros((r, stacked.shape[-1]), dtype=bank.dtype,
                               device=dev)
        if op == "truncate":
            return bank.lens                        # keep current length
        # shift: the empty range [1, 0] moves nothing
        fill = 1 if name == "start" else 0
        return torch.full((r,), fill, dtype=torch.int32, device=dev)

    def compiled_commit(self, bank_id: int, k: int, rows: int | None = None):
        """The serving hot path's packing, pre-collapsed: every row runs
        the same ``insert(k tokens) -> truncate`` stream, so the flush is
        one function ``(data, lens, toks (rows, k), emit (rows,)) ->
        (data, lens)`` — ONE ``fused_stream`` launch on a cuda bank.
        ``rows`` overrides the row count when the commit runs on the
        caller's gathered *logical* rows (the paged pool)."""
        bank = self.banks[bank_id]
        return packed_commit(bank.backend,
                             bank.slots if rows is None else rows, k)


def packed_commit(backend: str, slots: int, k: int):
    """The packed commit (see :meth:`MultiBankScheduler.compiled_commit`):
    each row's ``k`` chunk tokens append at its tail and the length
    register rolls back to ``lens + emit`` — rows with ``emit`` 0 are
    untouched in their live region, overshoot tokens land past
    ``used_len``.  Built on ``CPMProgram`` and the fusing scheduler;
    parameterized by routing and shape only, so it holds no bank."""
    def run(data, lens, toks, emit):
        dev = CPMArray(data, lens, backend)
        prog = (CPMProgram()
                .append("insert", pos=lens, values=toks)
                .append("truncate", new_len=lens + emit))
        out, _ = schedule(prog).run(dev, backend=backend)
        return out.data, torch.as_tensor(
            out.used_len, dtype=torch.int32,
            device=data.device).expand(slots).contiguous()

    return run
