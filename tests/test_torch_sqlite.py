"""The port's sqlite state store and broker against the JAX package's: the
same operations give the same results and etag refusals, a file written
by either is read or delivered by the other, a deferring nack charges no
attempt, ``max_attempts`` ends in a dead letter, and an expired lease is
redelivered."""

import asyncio
import json
import sqlite3

import pytest

from tasksrunner.pubsub.base import Nack as JaxNack
from tasksrunner.pubsub.sqlite import SqliteBroker as JaxBroker
from tasksrunner.state.base import TransactionOp as JaxOp
from tasksrunner.state.sqlite import SqliteStateStore as JaxStore
from tasksrunner_torch.pubsub import Nack
from tasksrunner_torch.pubsub.sqlite import SqliteBroker
from tasksrunner_torch.state import TransactionOp
from tasksrunner_torch.state.sqlite import SqliteStateStore

TOPIC, GROUP = "tasksavedtopic", "priority-scorer"
STORES = {"jax": (JaxStore, JaxOp), "port": (SqliteStateStore, TransactionOp)}
BROKERS = {"jax": (JaxBroker, JaxNack), "port": (SqliteBroker, Nack)}


def bounded(aw, seconds: float = 10):
    return asyncio.wait_for(aw, seconds)


async def _script(store, op_cls) -> list:
    """A fixed sequence of calls; each result, or the error's class name."""
    out = []

    async def call(aw):
        try:
            out.append(await bounded(aw))
        except Exception as exc:  # noqa: BLE001 - the error is the result
            out.append(type(exc).__name__)

    await call(store.set("a", {"n": 1, "s": "é"}))
    await call(store.set("b", [1, 2.5, None]))
    await call(store.set("a", {"n": 2}, etag="1"))
    await call(store.set("a", {"n": 3}, etag="1"))  # stale: refused
    await call(store.delete("b", etag="nope"))
    await call(store.delete("b"))
    await call(store.delete("b"))
    await call(store.delete("never", etag="1"))
    await call(store.transact([op_cls("upsert", "c", {"c": 1}), op_cls("delete", "a"),
                               op_cls("upsert", "d", 4, etag="99")]))  # refused whole
    await call(store.transact([op_cls("upsert", "c", {"c": 1}), op_cls("delete", "a")]))
    await call(store.set("nan", float("nan")))
    # concurrent writes coalesce into one batch where group commit is on
    await call(asyncio.gather(*(store.set(f"k{i}", i) for i in range(12))))
    items = await bounded(store.bulk_get(["a", "c", "k3", "zz"]))
    out.append([None if it is None else (it.key, it.value, it.etag) for it in items])
    got = await bounded(store.get("c"))
    out.append((got.key, got.value, got.etag))
    out.append(await bounded(store.keys()))
    return out


def _rows(path) -> list:
    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT key, value, etag FROM state ORDER BY key").fetchall()


@pytest.mark.parametrize("group_commit, cache_size", [(True, 0), (True, 16), (False, 0),
                                                      (False, 16)])
async def test_the_same_operations_give_the_same_results(tmp_path, group_commit, cache_size):
    results, rows = {}, {}
    for name, (cls, op_cls) in STORES.items():
        path = tmp_path / f"{name}.db"
        store = cls("s", path, group_commit=group_commit, cache_size=cache_size)
        try:
            results[name] = await _script(store, op_cls)
        finally:
            store.close()
        rows[name] = _rows(path)
    assert results["port"] == results["jax"]
    assert "EtagMismatch" in results["port"] and "StateError" in results["port"]
    # the same documents under the same etags, byte for byte
    assert rows["port"] == rows["jax"]


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
async def test_a_store_file_written_by_either_reads_back_in_the_other(tmp_path, writer, reader):
    path = tmp_path / "scores.db"
    wcls, wop = STORES[writer]
    store = wcls("scores", path)
    try:
        for i in range(5):
            await bounded(store.set(f"priority-scorer||t-{i}", {"priority": "high", "i": i}))
        await bounded(store.transact([wop("delete", "priority-scorer||t-4")]))
        written = [await bounded(store.get(f"priority-scorer||t-{i}")) for i in range(5)]
    finally:
        store.close()
    rcls, _ = STORES[reader]
    store = rcls("scores", path)
    try:
        read = [await bounded(store.get(f"priority-scorer||t-{i}")) for i in range(5)]
        assert [(r.key, r.value, r.etag) if r else None for r in read] == \
               [(w.key, w.value, w.etag) if w else None for w in written]
        assert read[4] is None
        # the etag sequence goes on from where the writer left it
        assert await bounded(store.set("next", 1)) == "6"
        with pytest.raises(Exception, match="etag mismatch"):
            await bounded(store.set("priority-scorer||t-0", 0, etag="2"))
    finally:
        store.close()


def _schema(path) -> list:
    with sqlite3.connect(path) as conn:
        return sorted(conn.execute("SELECT type, name, sql FROM sqlite_master").fetchall())


async def _collect(broker, n: int, group: str = GROUP) -> list:
    got: list = []
    done = asyncio.Event()

    async def handler(msg):
        got.append(msg)
        if len(got) >= n:
            done.set()
        return True

    sub = await bounded(broker.subscribe(TOPIC, group, handler))
    try:
        await bounded(done.wait())
    finally:
        await bounded(sub.cancel() if hasattr(sub, "cancel") else sub())
    return got


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
async def test_a_broker_file_written_by_either_is_delivered_by_the_other(tmp_path, writer,
                                                                         reader):
    path = tmp_path / "pubsub.db"
    wcls, _ = BROKERS[writer]
    broker = wcls("taskspubsub", path)
    try:
        await bounded(broker.ensure_group(TOPIC, GROUP))
        ids = [await bounded(broker.publish(TOPIC, {"taskId": f"t-{i}"},
                                            metadata={"traceparent": f"tp-{i}"}))
               for i in range(5)]
    finally:
        await bounded(broker.aclose())
    rcls, _ = BROKERS[reader]
    broker = rcls("taskspubsub", path, gc_interval=0)
    try:
        got = await _collect(broker, 5)
        assert [(m.id, m.topic, m.data, m.metadata, m.attempt) for m in got] == [
            (ids[i], TOPIC, {"taskId": f"t-{i}"}, {"traceparent": f"tp-{i}"}, 1)
            for i in range(5)]
        assert broker.backlog(TOPIC, GROUP) == 0
    finally:
        await bounded(broker.aclose())
    other = tmp_path / "fresh.db"
    cls, _ = BROKERS[reader]
    (cls("x", other)).close_sync()
    assert _schema(other) == _schema(path)


@pytest.mark.parametrize("impl", ["jax", "port"])
async def test_a_deferring_nack_charges_no_attempt(tmp_path, impl):
    cls, nack = BROKERS[impl]
    broker = cls("b", tmp_path / "b.db", max_attempts=1, gc_interval=0)
    seen: list[int] = []
    done = asyncio.Event()

    async def handler(msg):
        seen.append(msg.attempt)
        if len(seen) < 3:  # a warm-up's 503, twice
            return nack(retry_after=0.05, counts_attempt=False)
        done.set()
        return True

    try:
        sub = await bounded(broker.subscribe(TOPIC, GROUP, handler))
        await bounded(broker.publish(TOPIC, {"taskId": "t"}))
        await bounded(done.wait())
        await bounded(sub.cancel() if hasattr(sub, "cancel") else sub())
        assert seen == [1, 1, 1]
        assert broker.dead_letters(TOPIC, GROUP) == [] and broker.backlog(TOPIC, GROUP) == 0
    finally:
        await bounded(broker.aclose())


@pytest.mark.parametrize("impl", ["jax", "port"])
async def test_max_attempts_ends_in_a_dead_letter(tmp_path, impl):
    cls, _ = BROKERS[impl]
    broker = cls("b", tmp_path / "b.db", max_attempts=2, retry_delay=0.01, gc_interval=0)
    seen: list[int] = []

    async def handler(msg):
        seen.append(msg.attempt)
        return False

    try:
        sub = await bounded(broker.subscribe(TOPIC, GROUP, handler))
        msg_id = await bounded(broker.publish(TOPIC, {"taskId": "t"}))

        async def dead():
            while broker.dead_letters(TOPIC, GROUP) != [msg_id]:
                await asyncio.sleep(0.01)
        await bounded(dead())
        await bounded(sub.cancel() if hasattr(sub, "cancel") else sub())
        assert seen == [1, 2] and broker.backlog(TOPIC, GROUP) == 0
    finally:
        await bounded(broker.aclose())


@pytest.mark.parametrize("claimer, redeliverer", [("jax", "port"), ("port", "jax"),
                                                  ("port", "port")])
def test_an_expired_lease_is_redelivered(tmp_path, claimer, redeliverer):
    """A consumer that claimed and died: its lease runs out and the
    message comes back, its attempt counted."""
    path = tmp_path / "b.db"
    first = BROKERS[claimer][0]("b", path, claim_lease=0.3)
    second = BROKERS[redeliverer][0]("b", path, claim_lease=0.3)
    try:
        first._ensure_group_sync(TOPIC, GROUP)
        with sqlite3.connect(path) as conn:  # one message, published before the claim
            conn.execute("INSERT INTO messages VALUES ('m1', ?, ?, '{}', 0)",
                         (TOPIC, json.dumps({"taskId": "t"})))
            conn.execute("INSERT INTO deliveries(msg_id, topic, grp, visible_at) "
                         "VALUES ('m1', ?, ?, 0)", (TOPIC, GROUP))
        (claimed,) = first._claim_and_ack(TOPIC, GROUP, 10, [])
        assert (claimed.id, claimed.attempt) == ("m1", 1)
        assert second._claim_and_ack(TOPIC, GROUP, 10, []) == []  # leased
        import time
        time.sleep(0.35)
        (again,) = second._claim_and_ack(TOPIC, GROUP, 10, [])
        assert (again.id, again.attempt, again.data) == ("m1", 2, {"taskId": "t"})
        second._ack_many(["m1"], GROUP)
        assert first.backlog(TOPIC, GROUP) == second.backlog(TOPIC, GROUP) == 0
    finally:
        first.close_sync()
        second.close_sync()
