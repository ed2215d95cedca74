"""The port's training data pipeline (``repro_torch.data.pipeline``) on
the CPU against the reference's (``repro.data.pipeline``): the same
batches bit for bit (tokens, labels, mask, weight) for several seeds,
steps and host slices, FROID == INTERPRETED on the port, host sharding,
and the compiled transform plan's ``explain()`` equal to the reference's.
"""
import re

import numpy as np
import pytest
import torch

from repro.data import pipeline as RP
from repro_torch.data import pipeline as TP

VOCAB = 49_155  # granite-3-2b's


@pytest.mark.parametrize("seed,steps", [(0, (0, 1, 2, 3)), (3, (5,)), (11, (0, 7))])
@pytest.mark.parametrize("froid", [True, False])
def test_batches_equal_the_reference(seed, steps, froid):
    ref = RP.DataPipeline(batch=8, seq_len=24, vocab=VOCAB, seed=seed, froid=froid)
    port = TP.DataPipeline(batch=8, seq_len=24, vocab=VOCAB, seed=seed, froid=froid,
                           device="cpu")
    for step in steps:
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels", "mask", "weight"}
        assert got["tokens"].dtype == got["labels"].dtype == torch.int64
        assert got["mask"].dtype == torch.bool and got["weight"].dtype == torch.float32
        for key in want:
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]).astype(
                got[key].numpy().dtype)), (seed, step, key)
        toks = TP.synthetic_corpus(seed, step, 8, 24, VOCAB)
        assert np.array_equal(toks, RP.synthetic_corpus(seed, step, 8, 24, VOCAB))
        assert np.array_equal(got["tokens"].numpy(), toks[:, :-1])


def test_froid_equals_interpreted():
    a = TP.DataPipeline(batch=16, seq_len=16, vocab=128, seed=3, froid=True, device="cpu")
    b = TP.DataPipeline(batch=16, seq_len=16, vocab=128, seed=3, froid=False, device="cpu")
    for step in range(4):
        x, y = a.batch_at(step), b.batch_at(step)
        for key in x:
            assert torch.equal(x[key], y[key]), (step, key)
    assert a.session.device == torch.device("cpu")


def test_host_sharding():
    full = TP.DataPipeline(batch=8, seq_len=16, vocab=128, seed=3, device="cpu")
    h0 = TP.DataPipeline(batch=8, seq_len=16, vocab=128, seed=3, host=0, num_hosts=2,
                         device="cpu")
    h1 = TP.DataPipeline(batch=8, seq_len=16, vocab=128, seed=3, host=1, num_hosts=2,
                         device="cpu")
    b0, b1 = h0.batch_at(0), h1.batch_at(0)
    assert b0["tokens"].shape[0] == 4 and b1["tokens"].shape[0] == 4
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert full.batch_at(0)["tokens"].shape[0] == 8
    ref1 = RP.DataPipeline(batch=8, seq_len=16, vocab=128, seed=3, host=1,
                           num_hosts=2).batch_at(0)
    assert np.array_equal(b1["tokens"].numpy(), np.asarray(ref1["tokens"]))
    assert np.array_equal(b1["mask"].numpy(), np.asarray(ref1["mask"]))


def _norm(text: str) -> str:
    return re.sub(r"0x[0-9a-f]+", "0x", text)


def test_compiled_plan_explains_as_the_reference():
    ref = RP.DataPipeline(batch=4, seq_len=16, vocab=128, seed=0)
    port = TP.DataPipeline(batch=4, seq_len=16, vocab=128, seed=0, device="cpu")
    ref.batch_at(0)
    port.batch_at(0)
    want = ref.session.explain(ref._query, ref.policy)
    got = port.session.explain(port._query, port.policy)
    assert "UdfCall" not in got  # both UDFs inlined
    assert _norm(got) == _norm(want)
