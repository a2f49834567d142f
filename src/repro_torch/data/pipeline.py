"""Packed LM dataset with FFD sequence packing (the paper applied to data);
a copy of ``repro.data.pipeline`` (numpy; the stream equals the
reference's batch for batch).

Documents have different sizes; a training row is a reducer of capacity
seq_len.  FFD packing (``repro_torch.core.binpack``) minimizes padding
waste exactly like the paper's bins minimize reducer waste; cross-document
attention is prevented with segment-aware loss masking (targets crossing a
boundary are masked).

State (epoch seed + cursor) is checkpointable; restoring reproduces the
exact stream (preemption-safe pipelines for FT).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.binpack import ffd

__all__ = ["PackedLMDataset", "packing_efficiency"]


@dataclasses.dataclass
class PackedLMDataset:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    doc_len_lognormal: tuple[float, float] = (5.5, 0.8)  # mean ~350 tokens
    docs_per_shot: int = 512
    pack: bool = True

    def __post_init__(self):
        self._emitted = 0

    # --------------------------------------------------------------- state
    def state(self) -> dict:
        """Checkpointable cursor: the stream is a pure function of
        (seed, batches emitted) — restore replays deterministically."""
        return {"seed": self.seed, "emitted": self._emitted}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self._emitted = int(state.get("emitted", state.get("cursor", 0)))

    # --------------------------------------------------------------- stream
    def _documents(self, shot: int) -> list[np.ndarray]:
        """Zipf-distributed tokens (learnable unigram structure: a model
        training on this stream shows a real CE drop below ln(V), unlike a
        uniform stream whose entropy is already the floor)."""
        rng = np.random.default_rng((self.seed, shot))
        mu, sigma = self.doc_len_lognormal
        lens = np.clip(rng.lognormal(mu, sigma, self.docs_per_shot).astype(
            np.int64), 8, self.seq_len)
        ranks = np.arange(1, self.vocab_size)
        p = 1.0 / (ranks + 20.0)
        p /= p.sum()
        return [(rng.choice(ranks, size=l, p=p)).astype(np.int32)
                for l in lens]

    def _pack_shot(self, docs: list[np.ndarray]):
        rows, segs = [], []
        if self.pack:
            bins = ffd([len(d) for d in docs], float(self.seq_len))
        else:
            bins = [[i] for i in range(len(docs))]
        for b in bins:
            row = np.zeros(self.seq_len, np.int32)
            seg = np.zeros(self.seq_len, np.int32)
            off = 0
            for s, i in enumerate(b):
                d = docs[i]
                row[off: off + len(d)] = d
                seg[off: off + len(d)] = s + 1
                off += len(d)
            rows.append(row)
            segs.append(seg)
        return rows, segs

    def __iter__(self) -> Iterator[dict]:
        rows_buf, segs_buf = [], []
        shot, skip = 0, self._emitted
        while True:
            while len(rows_buf) < self.batch_size:
                rows, segs = self._pack_shot(self._documents(shot))
                rows_buf.extend(rows)
                segs_buf.extend(segs)
                shot += 1
            rows = np.stack(rows_buf[: self.batch_size])
            segs = np.stack(segs_buf[: self.batch_size])
            rows_buf = rows_buf[self.batch_size:]
            segs_buf = segs_buf[self.batch_size:]
            if skip > 0:       # replaying up to the checkpointed cursor
                skip -= 1
                continue
            self._emitted += 1
            tokens = rows
            targets = np.roll(rows, -1, axis=1)
            # mask: next token must exist and stay within the same document
            same_seg = (segs == np.roll(segs, -1, axis=1)) & (segs > 0)
            same_seg[:, -1] = False
            yield {
                "tokens": tokens,
                "targets": targets,
                "mask": same_seg.astype(np.float32),
                "segments": segs,
            }


def packing_efficiency(batch) -> float:
    """Fraction of non-pad tokens in a batch (FFD vs naive comparison)."""
    return float((batch["segments"] > 0).mean())
