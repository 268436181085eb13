"""The port's copy of the paged-KV control plane against the reference's
``repro.serve.paging``: the same seeded sequence of engine-like operations
gives the same block ids, refcounts, cache contents and evictions."""

import random

import pytest

from repro.serve import paging as ref_paging
from repro_torch.serve import paging as port_paging


def _run(m, seed: int) -> list:
    """Drive allocator, sequences and prefix cache of module ``m`` the way
    the engine does (admit with prefix match, copy-on-write, grow, commit,
    retire, evict under pressure) and record everything observable."""
    rng = random.Random(seed)
    bs = rng.choice([2, 4])
    alloc = m.BlockAllocator(rng.randint(6, 24), bs)
    cache = m.PrefixCache(alloc)
    prefixes = [[rng.randint(0, 5) for _ in range(rng.randint(1, 9))]
                for _ in range(3)]
    live: list = []
    obs: list = []

    def snap(tag, *extra):
        obs.append((tag, *extra, tuple(alloc._free), tuple(alloc._ref),
                    cache.blocks_cached, cache.lookups, cache.hits,
                    cache.tokens_matched))

    for _ in range(60):
        op = rng.random()
        if op < 0.4:  # admit a request
            prompt = rng.choice(prefixes) + [rng.randint(0, 5)
                                             for _ in range(rng.randint(0, 5))]
            blocks, n, tail = cache.match(prompt)
            seq = m.SequenceBlocks(alloc)
            seq.adopt(blocks, n)
            snap("match", tuple(blocks), n, tail)
            try:
                dst, src = seq.ensure_writable()
                new = seq.ensure_capacity(len(prompt) - n)
            except m.OutOfBlocks:
                snap("stall")
                cache.evict(rng.randint(1, 3))
                seq.free()
                snap("evict")
                continue
            seq.length = len(prompt)
            snap("grow", dst, src, tuple(new))
            cache.insert(prompt, seq.blocks, len(prompt))
            live.append(seq)
            snap("insert", tuple(seq.blocks))
        elif op < 0.7 and live:  # decode a token into a live sequence
            seq = rng.choice(live)
            try:
                dst, src = seq.ensure_writable()
                new = seq.ensure_capacity(1)
            except m.OutOfBlocks:
                snap("full")
                continue
            seq.length += 1
            snap("decode", dst, src, tuple(new), tuple(seq.blocks))
        elif op < 0.9 and live:  # retire
            live.pop(rng.randrange(len(live))).free()
            snap("retire")
        else:
            released = cache.evict(rng.randint(1, 4))
            snap("evict", released)
        alloc.check()
    for seq in live:
        seq.free()
    cache.evict(alloc.capacity)
    snap("drained", alloc.blocks_free == alloc.capacity)
    return obs


@pytest.mark.parametrize("seed", range(12))
def test_paging_matches_reference(seed):
    ours = _run(port_paging, seed)
    assert ours == _run(ref_paging, seed)
    assert ours[-1][1] is True  # every block back in the pool


def test_allocator_basics():
    a = port_paging.BlockAllocator(num_blocks=8, block_size=4)
    assert a.capacity == 7  # block 0 reserved as scratch
    blocks = [a.alloc() for _ in range(7)]
    assert port_paging.BlockAllocator.SCRATCH not in blocks
    with pytest.raises(port_paging.OutOfBlocks):
        a.alloc()
    for b in blocks:
        a.decref(b)
    assert a.blocks_free == a.capacity
    a.check()
