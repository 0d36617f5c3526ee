"""The generator: the same sizes in the same order for every seed, other
tokens."""

import collections

from benchmarks import harness, traffic

CHAT = harness.load_json(harness.HERE / "traffic" / "serve-chat.json")
# serve-chat's sizes over 8 adapters by Zipf (s = 1) popularity
MULTI = dict(CHAT, adapters={"names": [f"tenant-{k}" for k in range(8)],
                             "zipf_s": 1.0})
BIG = 2 ** 33 + 17  # seeds wider than 32 bits


def _sizes(reqs):
    return collections.Counter((r["prompt_len"], r["max_new"], r["adapter"])
                               for r in reqs)


def test_same_sizes_other_tokens():
    a = traffic.requests(CHAT, BIG, 32000)
    b = traffic.requests(CHAT, BIG + 1, 32000)
    assert _sizes(a) == _sizes(b)
    assert [r["prompt_len"] for r in a] == [r["prompt_len"] for r in b]
    assert [r["prompt"] for r in a] != [r["prompt"] for r in b]
    assert traffic.requests(CHAT, BIG, 32000) == a


def test_lengths_within_the_mix():
    for r in traffic.requests(CHAT, 3, 32000):
        assert 32 <= r["prompt_len"] <= 1024 == CHAT["prompt_len"]["max"]
        assert 32 <= r["max_new"] <= 128
        assert len(r["prompt"]) == r["prompt_len"]
        assert all(0 <= t < 32000 for t in r["prompt"])
    med = sorted(r["prompt_len"] for r in traffic.request_pool(CHAT))
    assert abs(med[len(med) // 2] - 192) < 20


def test_zipf_adapters():
    counts = collections.Counter(r["adapter"]
                                 for r in traffic.request_pool(MULTI))
    n = [counts[f"tenant-{k}"] for k in range(8)]
    assert sum(n) == MULTI["pool"]
    assert n == sorted(n, reverse=True) and n[0] > 2 * n[3] and n[7] >= 1


def test_train_batches():
    mix = {"batch": 2, "seq": 16, "batches": 3}
    a = traffic.train_batches(mix, BIG, 32000)
    assert len(a) == 3 and a[0].shape == (2, 17)
    assert not (a[0] == a[1]).all()
    assert all((x == y).all() for x, y in zip(
        a, traffic.train_batches(mix, BIG, 32000)))
