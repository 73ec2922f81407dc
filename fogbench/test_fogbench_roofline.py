"""The rooflines' byte counts against counts worked out by hand.

Two caches of two sets of two ways, one payload float.  Cache 0 holds key
10 in set 0 way 0 (ts 1) and key 11 in set 1 way 0 (ts 5); cache 1 holds key
11 in set 1 way 0 (ts 1) and key 13 in set 1 way 1 (ts 2); every other way
is empty.
"""
from __future__ import annotations

import types

import pytest
import torch

from fogbench import roofline

I32 = torch.int32


def tables():
    tags = torch.tensor([[[10, -1], [11, -1]], [[-1, -1], [11, 13]]], dtype=I32)
    ts = torch.tensor([[[1, -1], [5, -1]], [[-1, -1], [1, 2]]], dtype=I32)
    valid = tags != -1
    last_use = torch.zeros_like(ts)
    data = torch.zeros((2, 2, 2, 1))
    return tags, ts, valid, last_use, data


@pytest.mark.parametrize("fanout, expected", [(None, 102), (1, 100)])
def test_update_work_by_hand(fanout, expected):
    """Rows: key 10 to set 0 and key 11 to set 1, both at ts 3; cache 0
    hears both, cache 1 the second.  Delivery 4 bytes dense (2 x 2), 2 as
    one lane a cache; keys and sets of 2 live rows 16; ts of 2 matching
    rows 8; valid flags of 3 touched sets 6; tags of their 4 valid ways 16;
    ts of 3 matched lines 12; payloads of the 2 winning rows 8; 2 updated
    lines written 24; counts 8.  Operations: 3 live pairs x 2 ways x 3."""
    tags, ts, valid, last_use, data = tables()
    keys = torch.tensor([10, 11], dtype=I32)
    sidx = torch.tensor([0, 1], dtype=I32)
    row_ts = torch.tensor([3, 3], dtype=I32)
    live = torch.tensor([[True, True], [False, True]])
    nbytes, ops = roofline.update_work(tags, ts, valid, last_use, data, keys, sidx, row_ts,
                                       torch.zeros((2, 1)), live, 7, fanout=fanout)
    assert (nbytes, ops) == (expected, 18)


def test_lookup_work_by_hand():
    """Queries: key 10 (set 0), key 11 (set 1), key 99 (set 1, held
    nowhere).  Keys and sets 24; valid flags of 2 queried sets in 2 caches
    8; tags of 4 valid ways 16; ts of 3 matched lines 12; one payload read
    for each of 2 held keys 8 and one written for each of 2 answered queries
    8, not the (2, 3, 1) block; hit, ts and way of 2 x 3 pairs 54.
    Operations: 2 x 3 pairs x 2 ways x 3."""
    tags, ts, valid, _, data = tables()
    keys = torch.tensor([10, 11, 99], dtype=I32)
    sidx = torch.tensor([0, 1, 1], dtype=I32)
    assert roofline.lookup_work(tags, ts, valid, data, keys, sidx) == (130, 36)


def test_counts_do_not_depend_on_the_block_size(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    n, s, w, r = 9, 5, 4, 13
    tags = torch.randint(0, 12, (n, s, w), generator=gen, dtype=I32)
    ts = torch.randint(0, 5, (n, s, w), generator=gen, dtype=I32)
    valid = torch.rand((n, s, w), generator=gen) < 0.7
    data = torch.zeros((n, s, w, 2))
    keys = torch.randint(0, 12, (r,), generator=gen, dtype=I32)
    sidx = torch.randint(0, s, (r,), generator=gen, dtype=I32)
    row_ts = torch.randint(0, 7, (r,), generator=gen, dtype=I32)
    live = torch.rand((n, r), generator=gen) < 0.6
    args = (tags, ts, valid, torch.zeros_like(ts), data, keys, sidx, row_ts,
            torch.zeros((r, 2)), live, 0)
    whole = (roofline.update_work(*args), roofline.lookup_work(tags, ts, valid, data, keys, sidx))
    monkeypatch.setattr(roofline, "BLOCK_ELEMS", 1)
    assert (roofline.update_work(*args),
            roofline.lookup_work(tags, ts, valid, data, keys, sidx)) == whole


def test_share_and_bound():
    assert roofline.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound(1.0, 67e12 * 2) == (2.0, "operations")
    op = types.SimpleNamespace(dur=2000.0)          # 2 ms
    view = types.SimpleNamespace(captured={"flic_update": [(3.35e9, 0)]},
                                 named=lambda k: [op, op])
    assert roofline.share(view, "flic_update") == pytest.approx(50.0)
    assert roofline.share(view, "flic_lookup") is None
