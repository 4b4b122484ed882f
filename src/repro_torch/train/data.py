"""Deterministic synthetic LM data with checkpointable state (a copy of
``repro.train.data``, NumPy only: the stream is the JAX package's for
every seed, step and process index).

A real deployment swaps ``SyntheticTokens`` for a tokenized corpus
reader; the interface (a stateful iterator with ``state()`` /
``restore()`` for the checkpoint, per-host sharding by process index) is
what the trainer depends on.  Under data parallelism ``process_index``
/ ``process_count`` are the rank's coordinate on the data axes and their
size (``sharding.dp_rank`` / ``dp_size``), as JAX's host index is, so
the ranks of one model group read the same rows.  Tokens are a
counter-based hash of (seed, process, step), so a restored pipeline
reproduces the exact stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0
    # per-host sharding (one process: 0 of 1)
    process_index: int = 0
    process_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.process_count == 0
        return self.global_batch // self.process_count

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, self.process_index, self.step]))
        toks = rng.integers(0, self.vocab_size,
                            (self.host_batch, self.seq_len), dtype=np.int32)
        # learnable structure: token t+1 follows from token t
        toks[:, 1::2] = (toks[:, 0::2] * 31 + 7) % self.vocab_size
        self.step += 1
        return {"tokens": toks}

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])


def make_pipeline(cfg, shape, seed: int = 0,
                  process_index: int = 0, process_count: int = 1):
    return SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                           global_batch=shape.global_batch, seed=seed,
                           process_index=process_index,
                           process_count=process_count)
