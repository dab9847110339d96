"""The port's DaphneSched-scheduled data pipeline (``data/pipeline.py``):
copies of the reference's ``tests/test_data_pipeline.py`` on the port's
``ScheduledExecutor``, and its token matrices bitwise the reference's for
each step. Which worker packs a row is up to the threads; what goes in it
is not, and that is all the tests assert."""

import numpy as np
import pytest

from repro.core import SchedulerConfig as JSchedulerConfig
from repro.data import DataPipeline as JDataPipeline
from repro.data import SyntheticCorpus as JSyntheticCorpus
from repro_torch.core import SchedulerConfig
from repro_torch.data import DataPipeline, SyntheticCorpus


def _pipe(technique="GSS", layout="PERCORE"):
    corpus = SyntheticCorpus(vocab_size=1000, mean_len=64, seed=0)
    sched = SchedulerConfig(technique=technique, queue_layout=layout,
                            victim_strategy="SEQPRI", n_workers=4,
                            numa_domains=(0, 0, 1, 1))
    return DataPipeline(corpus, global_batch=16, seq_len=128, sched=sched)


def test_batch_shapes_and_range():
    batches = list(_pipe().batches(3))
    assert len(batches) == 3
    for b in batches:
        assert b["tokens"].shape == (16, 129)
        assert b["tokens"].dtype == np.int32
        assert (b["tokens"] >= 0).all() and (b["tokens"] < 1000).all()


def test_deterministic_given_step():
    a = next(iter(_pipe().batches(1, start_step=7)))
    b = next(iter(_pipe().batches(1, start_step=7)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_scheduling_invariant_content():
    """Batch content must not depend on the scheduling technique (the
    scheduler decides WHO packs a row, never WHAT goes in it)."""
    a = next(iter(_pipe("STATIC", "CENTRALIZED").batches(1)))
    b = next(iter(_pipe("PSS", "PERGROUP").batches(1)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_prefetch_yields_all():
    got = list(_pipe().prefetch(4, depth=2))
    assert len(got) == 4
    ref = list(_pipe().batches(4))
    np.testing.assert_array_equal(got[2]["tokens"], ref[2]["tokens"])


@pytest.mark.parametrize("technique,layout", [("GSS", "PERCORE"), ("FAC2", "PERGROUP"),
                                              ("STATIC", "CENTRALIZED")])
def test_token_matrices_are_the_references(technique, layout):
    """Steps 0-2 and 9 of the launcher's pipeline shape (GSS, PERCORE,
    SEQPRI, 4 workers) and of two other techniques: bitwise the
    reference's, through ``prefetch`` as the launcher takes them."""
    kw = dict(technique=technique, queue_layout=layout, victim_strategy="SEQPRI",
              n_workers=4, numa_domains=(0, 0, 1, 1))
    ours = DataPipeline(SyntheticCorpus(vocab_size=151936, mean_len=32), 8, 64,
                        sched=SchedulerConfig(**kw))
    ref = JDataPipeline(JSyntheticCorpus(vocab_size=151936, mean_len=32), 8, 64,
                        sched=JSchedulerConfig(**kw))
    got = list(ours.prefetch(3)) + list(ours.batches(1, start_step=9))
    want = list(ref.batches(3)) + list(ref.batches(1, start_step=9))
    for g, w in zip(got, want, strict=True):
        assert g["tokens"].dtype == w["tokens"].dtype
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    assert ours.last_stats is not None


def test_prefetch_raises_the_producers_error():
    """A failure while packing reaches the consumer instead of leaving it
    waiting on an empty queue."""
    pipe = _pipe()
    assemble = pipe.assemble

    def broken(step):
        if step == 1:
            raise ValueError("bad batch")
        return assemble(step)

    pipe.assemble = broken
    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for b in pipe.prefetch(3):
            got.append(b)
    assert len(got) == 1
