"""Concurrency of the PyTorch port's host side (tests/test_concurrency.py
for the JAX package): the port's own CellStore under concurrent producers
and consumers, and two port Triggers on threads (two antennas) publishing
into one shared CellStore, on a synthetic cell: each publishes the cell the
JAX Trigger publishes for the same stream, field for field."""

import threading

import numpy as np

from ltetrigger_tpu.models import api as japi
from ltetrigger_tpu_torch.models import api
from ltetrigger_tpu_torch.runtime.cellstore import Cell, CellStore
from test_torch_common import fields, frames, noise


def _mkcell(i):
    return Cell(cell_id=i, nof_tx_ports=1, cp_len="Normal", nof_prb=6,
                phich_len="Normal", nof_phich_resources="1", sfn_offset=0)


def test_cellstore_concurrent_track_drop():
    store = CellStore()
    n = 2000

    def producer(base):
        for i in range(n):
            store.track_cell(_mkcell(base + i))

    def dropper():
        dropped = 0
        while dropped < n:
            c = store.latest_cell()
            if c is not None:
                store.drop_cell(c)
                dropped += 1

    threads = [threading.Thread(target=producer, args=(0,)),
               threading.Thread(target=producer, args=(10000,)),
               threading.Thread(target=dropper)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(store.cells()) == n          # 2n tracked, n dropped
    assert store.tracking()


def test_cellstore_query_during_mutation():
    store = CellStore()
    stop = threading.Event()
    errors = []

    def reader():
        try:
            while not stop.is_set():
                store.cells()
                store.tracking()
                store.latest_cell()
        except Exception as e:              # reported by the assert below
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    for i in range(5000):
        store.track_cell(_mkcell(i))
        if i % 3 == 0:
            store.drop_cell_id(i)
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive() and not errors


def test_parallel_triggers_one_store():
    rng = np.random.default_rng(9)
    sig = (frames(123, 6, nof_prb_field=6)
           + noise(rng, 6 * 19200, 0.05)).astype(np.complex64)
    store = CellStore()
    results, errors = [], []

    def worker():
        try:
            t = api.Trigger(psr_threshold=4, cellstore=store, device="cpu")
            # pipelined delivery: flush() forces pending events out
            results.append(t.process(sig) + t.flush())
        except Exception as e:              # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    ref = japi.Trigger(psr_threshold=4)
    want = [fields(c) for c in ref.process(sig) + ref.flush()]
    assert want and want[0]["cell_id"] == 123
    assert len(results) == 2
    assert all([fields(c) for c in r] == want for r in results), results
    assert len(store.cells()) == 2 * len(want)
    assert {c.cell_id for c in store.cells()} == {123}
