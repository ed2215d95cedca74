"""Training data pipeline with Froid-compiled per-example transforms: a
port of ``src/repro/data/pipeline.py``.

The per-example logic (quality filtering, label masking, curriculum
weighting) is authored imperatively as UDFs and compiled by the port's
Froid core into one set-oriented plan per batch, which the session runs on
its device (the card unless ``device="cpu"``) — the paper's technique
applied to the framework's own input path.

Determinism & sharding: example i of step s is a pure function of
(seed, s, i), drawn with the reference's ``np.random.SeedSequence``
streams, so the tokens equal the reference's bit for bit; each
data-parallel host reads only its slice [host*per_host,
(host+1)*per_host), so restarts and elastic re-shards reproduce the exact
stream.  A batch is a dict of tensors on the session's device: ``tokens``
and ``labels`` int64 (for indexing), ``mask`` bool, ``weight`` float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (
    FROID,
    INTERPRETED,
    Session,
    UdfBuilder,
    col,
    lit,
    param,
    scan,
    udf,
    var,
)


def synthetic_corpus(seed: int, step: int, batch: int, seq_len: int, vocab: int,
                     host: int = 0, num_hosts: int = 1):
    """Deterministic synthetic token batch (counter-based RNG), int32
    numpy (per_host, seq_len + 1)."""
    per_host = batch // num_hosts
    ss = np.random.SeedSequence([seed, step, host])
    rng = np.random.default_rng(ss)
    toks = rng.integers(0, vocab, (per_host, seq_len + 1), dtype=np.int32)
    return toks


def default_transforms(db):
    """Imperative per-example rules compiled by Froid.

    keep_example(doc_score, length)  -> quality filter
    loss_weight(doc_score, repeats)  -> curriculum weight
    """
    u = UdfBuilder("keep_example", [("score", "float32"), ("length", "int32")],
                   "bool")
    with u.if_(param("length") < 16):
        u.return_(lit(False))
    with u.if_(param("score") < 0.2):
        u.return_(lit(False))
    u.return_(lit(True))
    db.create_function(u.build())

    u = UdfBuilder("loss_weight", [("score", "float32"), ("repeats", "int32")],
                   "float32")
    u.declare("w", "float32", lit(1.0))
    with u.if_(param("score") > 0.8):
        u.set("w", lit(2.0))
    with u.if_(param("repeats") > 2):
        u.set("w", var("w") * 0.5)
    u.return_(var("w"))
    db.create_function(u.build())


@dataclasses.dataclass
class DataPipeline:
    batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host: int = 0
    num_hosts: int = 1
    froid: bool = True
    device: object = None  # the session's device: None is the card

    def __post_init__(self):
        self.session = Session(device=self.device)
        default_transforms(self.session)
        # a fresh examples table per batch -> eager froid (a plan compiled
        # for one table would be rebuilt every step)
        self.policy = FROID.eager() if self.froid else INTERPRETED
        self._query = scan("examples").compute(
            keep=udf("keep_example", col("score"), col("length")),
            w=udf("loss_weight", col("score"), col("repeats")),
        ).project("keep", "w")

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> dict:
        toks = synthetic_corpus(
            self.seed, step, self.batch, self.seq_len, self.vocab,
            self.host, self.num_hosts,
        )
        n = toks.shape[0]
        ss = np.random.SeedSequence([self.seed, step, self.host, 7])
        rng = np.random.default_rng(ss)
        meta = {
            "score": rng.random(n).astype(np.float32),
            "length": np.full(n, self.seq_len, np.int32),
            "repeats": rng.integers(0, 4, n).astype(np.int32),
        }
        self.session.create_table("examples", **meta)
        res = self.session.execute(self._query, self.policy)
        keep = res.table.columns["keep"].data.to(torch.bool)
        w = res.table.columns["w"].data.to(torch.float32)
        device = self.session.device
        toks = torch.as_tensor(toks, device=device).long()
        return {
            "tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous(),
            "mask": keep[:, None].expand(n, self.seq_len).contiguous(),
            "weight": w,
        }
