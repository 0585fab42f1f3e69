"""The port's SPSC ring queues against ``repro.core.queue``.

Random scripts of per-cycle handshakes, host batch pushes/pops, bulk
drains/fills and slab staging run on both packages from the same numpy
inputs; after every operation ``buf``/``head``/``tail`` must be equal bit
for bit (the queue logic is integer ring arithmetic over f32 copies).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queue as jq
from repro_torch.core import queue as tq


def _state(q):
    return [np.asarray(q.buf), np.asarray(q.head), np.asarray(q.tail)]


def _assert_same(jqa, tqa, what):
    for name, a, b in zip(("buf", "head", "tail"), _state(jqa),
                          [t.numpy() for t in (tqa.buf, tqa.head, tqa.tail)]):
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, name, a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap", [2, 5])
def test_random_scripts_match_reference(seed, cap):
    rng = np.random.RandomState(seed * 31 + cap)
    n, W = 5, 2
    jqa = jq.make_queues(n, W, cap)
    tqa = tq.make_queues(n, W, cap, device="cpu")
    for step in range(40):
        op = rng.randint(5)
        if op == 0:  # one cycle of handshakes
            pay = rng.randint(0, 100, size=(n, W)).astype(np.float32)
            pv = rng.rand(n) < 0.7
            pr = rng.rand(n) < 0.5
            jqa, jp, jd = jq.cycle(jqa, jnp.asarray(pay), jnp.asarray(pv), jnp.asarray(pr))
            tqa, tp, td = tq.cycle(tqa, torch.from_numpy(pay), torch.from_numpy(pv),
                                   torch.from_numpy(pr))
            assert np.array_equal(np.asarray(jp), tp.numpy())
            assert np.array_equal(np.asarray(jd), td.numpy())
        elif op == 1:  # host batch push (oversize batches truncate)
            i = int(rng.randint(n))
            k = int(rng.randint(1, cap + 3))
            pays = rng.randint(0, 100, size=(k, W)).astype(np.float32)
            jqa, jn = jq.host_push_many(jqa, i, jnp.asarray(pays))
            tqa, tn = tq.host_push_many(tqa, i, torch.from_numpy(pays))
            assert int(jn) == int(tn)
        elif op == 2:  # host batch pop
            i = int(rng.randint(n))
            m = int(rng.randint(1, cap))
            jqa, jpays, jc = jq.host_pop_many(jqa, i, m)
            tqa, tpays, tc = tq.host_pop_many(tqa, i, m)
            c = int(jc)
            assert c == int(tc)
            assert np.array_equal(np.asarray(jpays)[:c], tpays.numpy()[:c])
        elif op == 3:  # credit-bounded bulk drain, then a bulk fill
            m = int(rng.randint(1, cap))
            lim = rng.randint(0, cap, size=n).astype(np.int32)
            jqa, jslab, jc = jq.drain(jqa, m, limit=jnp.asarray(lim))
            tqa, tslab, tc = tq.drain(tqa, m, limit=torch.from_numpy(lim))
            assert np.array_equal(np.asarray(jc), tc.numpy())
            _assert_same(jqa, tqa, ("drain", step))
            pays = rng.randint(0, 100, size=(n, m, W)).astype(np.float32)
            cnt = rng.randint(0, m + 1, size=n).astype(np.int32)
            jqa = jq.fill(jqa, jnp.asarray(pays), jnp.asarray(cnt))
            tqa = tq.fill(tqa, torch.from_numpy(pays), torch.from_numpy(cnt))
        else:  # slab staging on a row subset with 0-limit padding rows
            # padding points at the scratch row 0 (duplicated, never a real
            # row), as in the fused engine's exchange tables
            rows = (1 + rng.permutation(n - 1)[:3]).astype(np.int32)
            idx = np.concatenate([rows, [0, 0]]).astype(np.int32)
            lim = np.concatenate([rng.randint(0, cap, size=3), [0, 0]]).astype(np.int32)
            m = int(rng.randint(1, cap))
            jqa, jslab, jc = jq.stage_drain(jqa, jnp.asarray(idx), m, limit=jnp.asarray(lim))
            tqa, tslab, tc = tq.stage_drain(tqa, torch.from_numpy(idx), m,
                                            limit=torch.from_numpy(lim))
            jc, tc = np.asarray(jc), tc.numpy()
            assert np.array_equal(jc, tc)
            for r in range(len(idx)):
                assert np.array_equal(np.asarray(jslab)[r, :jc[r]], tslab.numpy()[r, :tc[r]])
            _assert_same(jqa, tqa, ("stage_drain", step))
            pays = rng.randint(0, 100, size=(len(idx), m, W)).astype(np.float32)
            cnt = np.concatenate([rng.randint(0, m + 1, size=3), [0, 0]]).astype(np.int32)
            jqa = jq.stage_fill(jqa, jnp.asarray(idx), jnp.asarray(pays), jnp.asarray(cnt))
            tqa = tq.stage_fill(tqa, torch.from_numpy(idx), torch.from_numpy(pays),
                                torch.from_numpy(cnt))
        _assert_same(jqa, tqa, (op, step))
        assert np.array_equal(np.asarray(jq.size(jqa)), tq.size(tqa).numpy())
        assert np.array_equal(np.asarray(jq.full(jqa)), tq.full(tqa).numpy())


@pytest.mark.parametrize("cap", [2, 5, 62])
def test_ring_holds_capacity_minus_one(cap):
    """A ring of capacity C holds C-1 packets: an oversize host batch lands
    C-1 packets, the next push is refused, and a pop drains them in order."""
    q = tq.make_queues(1, 2, cap, device="cpu")
    pays = torch.arange(2 * (cap + 4), dtype=torch.float32).reshape(cap + 4, 2)
    q, n = tq.host_push_many(q, 0, pays)
    assert int(n) == cap - 1
    assert bool(tq.full(q)[0]) and int(tq.free(q)[0]) == 0
    q, ok = tq.host_push(q, 0, torch.tensor([7.0, 7.0]))
    assert not bool(ok)
    q, out, cnt = tq.host_pop_many(q, 0, cap - 1)
    assert int(cnt) == cap - 1
    assert torch.equal(out[: cap - 1], pays[: cap - 1])
    assert bool(tq.empty(q)[0])
    q, _, valid = tq.host_pop(q, 0)
    assert not bool(valid)
