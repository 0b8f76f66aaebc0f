"""Deterministic, resumable, shardable token pipeline (numpy only): a copy
of ``repro/data/pipeline.py``, so the port imports nothing of the JAX
package; batches are bit for bit the same.

Production posture:
  * deterministic: batch i is a pure function of (seed, i) — any worker can
    regenerate any batch, which is what makes straggler re-dispatch and
    elastic restarts correct.
  * resumable: PipelineState is one integer; it lives inside the
    checkpoint, so restore replays from the exact batch boundary.
  * shardable: ``shard_batch(i, host_id, n_hosts)`` yields this host's rows
    only; global batch order is host-count independent.

Two sources: synthetic LM streams (zipf-distributed tokens with local
n-gram structure so the loss actually decreases) and memory-mapped token
files (np.memmap) for real corpora.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    next_batch: int = 0

    def to_json(self) -> dict:
        return {"next_batch": self.next_batch}

    @staticmethod
    def from_json(d: dict) -> "PipelineState":
        return PipelineState(next_batch=int(d["next_batch"]))


class TokenPipeline:
    def __init__(self, *, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, token_file: str | None = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self._mm = None
        if token_file:
            self._mm = np.memmap(token_file, dtype=np.int32, mode="r")

    # -- synthetic stream -----------------------------------------------------
    def _synthetic(self, batch_idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, batch_idx))
        b, s, v = self.global_batch, self.seq_len, self.vocab
        # zipf-ish marginal + short-range repetition structure
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % (v - 2) + 2
        # repeat-previous with p=0.3 gives learnable bigram structure
        repeat = rng.random((b, s)) < 0.3
        shifted = np.roll(base, 1, axis=1)
        toks = np.where(repeat, shifted, base)
        toks[:, 0] = 1                                  # BOS
        return toks.astype(np.int32)

    def _from_file(self, batch_idx: int) -> np.ndarray:
        b, s = self.global_batch, self.seq_len
        n = b * (s + 1)
        start = (batch_idx * n) % max(1, len(self._mm) - n)
        flat = np.asarray(self._mm[start:start + n])
        return flat.reshape(b, s + 1)[:, :s].astype(np.int32)

    # -- public ----------------------------------------------------------------
    def batch(self, batch_idx: int) -> dict:
        toks = (self._from_file(batch_idx) if self._mm is not None
                else self._synthetic(batch_idx))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": toks, "labels": labels}

    def shard_batch(self, batch_idx: int, host_id: int,
                    n_hosts: int) -> dict:
        full = self.batch(batch_idx)
        assert self.global_batch % n_hosts == 0
        rows = self.global_batch // n_hosts
        sl = slice(host_id * rows, (host_id + 1) * rows)
        return {k: v[sl] for k, v in full.items()}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch(i)
            i += 1
