"""Paged KV-cache bookkeeping: block allocator, per-sequence tables, prefix cache.

The port's own copy of ``repro/serve/paging.py`` (pure Python, no device
code), so the port imports nothing of the reference.

The serving engine stores KV state in fixed-size *blocks* (``block_size``
tokens each) drawn from a shared pool, so a request only ever holds memory
proportional to its actual length — no ``max_len`` padding.  This module is
the pure-Python control plane for that pool:

- ``BlockAllocator``: free-list allocation with per-block reference counts.
  Physical block 0 is reserved as the scratch block (inactive batch rows
  write there; it is never handed out), so a block table full of zeros is
  always safe to index on-device.
- ``SequenceBlocks``: one request's logical->physical block list plus its
  token length.  Appending tokens allocates on block boundaries;
  ``ensure_writable`` performs copy-on-write when the write position lands
  in a block shared with the prefix cache or another request.
- ``PrefixCache``: a radix tree over *block-granular* token chunks.  Full
  prompt blocks are committed after prefill and shared (refcounted) across
  requests with the same prefix; a partially filled tail block may also be
  shared, in which case the adopting request copies it on first write
  (divergence).  Eviction is LRU over unreferenced leaves.

Everything here is host-side metadata; the device-side pools and the
gather/compute over them live in ``paged_model.py`` / the CUDA kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class OutOfBlocks(RuntimeError):
    """The pool has no free blocks (after cache eviction was attempted)."""


class BlockAllocator:
    """Fixed-pool block allocator: free list + per-block refcounts.

    Block ids run ``1..num_blocks-1``; block 0 is the reserved scratch
    block inactive device rows write into, so it is never allocated and
    never freed.  ``capacity`` is therefore ``num_blocks - 1``.
    """

    SCRATCH = 0

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is scratch)")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently freed blocks are re-used first (their
        # pool slabs are warm)
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks

    # ------------------------------------------------------------- queries

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_used(self) -> int:
        return self.capacity - len(self._free)

    def ref(self, block: int) -> int:
        return self._ref[block]

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size) if n_tokens > 0 else 0

    # ----------------------------------------------------------- lifecycle

    def alloc(self) -> int:
        if not self._free:
            raise OutOfBlocks(f"all {self.capacity} blocks in use")
        block = self._free.pop()
        assert self._ref[block] == 0
        self._ref[block] = 1
        return block

    def incref(self, block: int) -> None:
        if block == self.SCRATCH or self._ref[block] == 0:
            raise ValueError(f"incref on unowned block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        if block == self.SCRATCH or self._ref[block] == 0:
            raise ValueError(f"decref on unowned block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)

    def cow(self, block: int) -> tuple:
        """Copy-on-write: returns ``(block, None)`` when ``block`` is
        exclusively owned (safe to write in place), else allocates a fresh
        block, drops this owner's reference on the shared one, and returns
        ``(new_block, block)`` — the caller must copy the pool slab
        ``block -> new_block`` before writing."""
        if self._ref[block] <= 1:
            return block, None
        new = self.alloc()  # may raise OutOfBlocks: caller handles
        self._ref[block] -= 1  # shared, so never drops to 0 here
        return new, block

    def check(self) -> None:
        """Free-list conservation invariant (used by the property tests)."""
        assert len(set(self._free)) == len(self._free), "duplicate free block"
        for b in self._free:
            assert self._ref[b] == 0, f"free block {b} has refs"
        assert self._ref[self.SCRATCH] == 0
        live = sum(1 for b in range(1, self.num_blocks) if self._ref[b] > 0)
        assert live + len(self._free) == self.capacity


class SequenceBlocks:
    """One request's block list + token length (owns one ref per block)."""

    def __init__(self, alloc: BlockAllocator):
        self._alloc = alloc
        self.blocks: list = []
        self.length = 0  # tokens written

    def adopt(self, blocks: list, n_tokens: int) -> None:
        """Start from a cached prefix: share ``blocks`` (already
        increffed by the cache on match) covering ``n_tokens`` tokens."""
        assert not self.blocks and self.length == 0
        self.blocks = list(blocks)
        self.length = n_tokens

    def ensure_capacity(self, n_new_tokens: int) -> list:
        """Allocate blocks so positions ``length .. length+n-1`` are
        backed; returns the newly allocated block ids (for table updates).
        Raises ``OutOfBlocks`` without partial allocation."""
        need = self._alloc.blocks_for_tokens(self.length + n_new_tokens)
        extra = need - len(self.blocks)
        if extra <= 0:
            return []
        if extra > self._alloc.blocks_free:
            raise OutOfBlocks(f"need {extra} blocks, "
                              f"{self._alloc.blocks_free} free")
        new = [self._alloc.alloc() for _ in range(extra)]
        self.blocks.extend(new)
        return new

    def ensure_writable(self) -> tuple:
        """Copy-on-write guard for the block the next token lands in.
        Returns ``(dst, src)``: ``src`` is ``None`` unless the engine must
        copy pool slab ``src -> dst`` (the block was shared)."""
        idx = self.length // self._alloc.block_size
        if idx >= len(self.blocks):
            return None, None  # next write opens a fresh block
        dst, src = self._alloc.cow(self.blocks[idx])
        if src is not None:
            self.blocks[idx] = dst
        return dst, src

    def free(self) -> None:
        for b in self.blocks:
            self._alloc.decref(b)
        self.blocks = []
        self.length = 0


@dataclass
class _PrefixNode:
    """One cached block: keyed by its token chunk, linked radix-style."""

    tokens: tuple  # the block's token contents (len == fill)
    block: int
    fill: int  # tokens valid in the block (== block_size unless tail)
    parent: object = None
    children: dict = field(default_factory=dict)  # full-block chunks only
    tail: object = None  # at most one partial-tail child
    stamp: int = 0  # LRU clock


class PrefixCache:
    """Block-granular radix cache over committed prompt blocks.

    ``match`` walks full-block children and may finish on a shared partial
    tail; ``insert`` commits a finished prompt's blocks (increffing them on
    behalf of the cache); ``evict`` frees least-recently-used leaves whose
    blocks nobody else references.  The cache owns exactly one reference
    per cached block, so engine-side sequence frees never invalidate it.
    """

    def __init__(self, alloc: BlockAllocator):
        self._alloc = alloc
        self._root = _PrefixNode((), BlockAllocator.SCRATCH, 0)
        self._clock = 0
        self.blocks_cached = 0
        # hit accounting (engine-visible signals)
        self.lookups = 0
        self.hits = 0
        self.tokens_matched = 0

    def _touch(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.stamp = self._clock

    def match(self, tokens: list) -> tuple:
        """Longest cached prefix of ``tokens``.

        Returns ``(blocks, n_tokens, tail_shared)``; every returned block
        has been increffed for the caller (adopt them into a
        ``SequenceBlocks``).  ``tail_shared`` is True when the last block
        is a partially-filled shared tail — the adopter must copy-on-write
        before appending.  At most ``len(tokens) - 1`` tokens are matched
        so a fully cached prompt still computes its final-token logits."""
        self.lookups += 1
        bs = self._alloc.block_size
        usable = max(len(tokens) - 1, 0)
        node, blocks, n = self._root, [], 0
        while n + bs <= usable:
            child = node.children.get(tuple(tokens[n:n + bs]))
            if child is None:
                break
            node, n = child, n + bs
            blocks.append(child.block)
            self._touch(child)
        tail_shared = False
        if node.tail is not None:
            t = node.tail
            take = min(t.fill, usable - n)
            if take > 0 and tuple(tokens[n:n + take]) == t.tokens[:take]:
                blocks.append(t.block)
                n += take
                tail_shared = True
                self._touch(t)
        for b in blocks:
            self._alloc.incref(b)
        if n:
            self.hits += 1
        self.tokens_matched += n
        return blocks, n, tail_shared

    def insert(self, tokens: list, blocks: list, n_tokens: int) -> int:
        """Commit a prefilled prompt's blocks: ``tokens[:n_tokens]`` living
        in ``blocks``.  Already-cached levels are left alone (the first
        committer wins; the caller keeps its own duplicate blocks).
        Returns the number of blocks newly cached."""
        bs = self._alloc.block_size
        node, added, i = self._root, 0, 0
        while (i + 1) * bs <= n_tokens:
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = _PrefixNode(chunk, blocks[i], bs, parent=node)
                self._alloc.incref(blocks[i])
                node.children[chunk] = child
                added += 1
                self.blocks_cached += 1
            node = child
            self._touch(node)
            i += 1
        fill = n_tokens - i * bs
        if fill > 0 and node.tail is None and i < len(blocks):
            node.tail = _PrefixNode(tuple(tokens[i * bs:n_tokens]),
                                    blocks[i], fill, parent=node)
            self._alloc.incref(blocks[i])
            added += 1
            self.blocks_cached += 1
            self._touch(node.tail)
        return added

    # ------------------------------------------------------------ eviction

    def _leaves(self) -> list:
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.tail is not None:
                stack.append(node.tail)
            if node is not self._root and not node.children and node.tail is None:
                out.append(node)
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` LRU leaf blocks nobody else references.
        Returns how many were released to the allocator."""
        released = 0
        while released < n_blocks:
            victims = [lf for lf in self._leaves()
                       if self._alloc.ref(lf.block) == 1]
            if not victims:
                break
            leaf = min(victims, key=lambda lf: lf.stamp)
            parent = leaf.parent
            if parent.tail is leaf:
                parent.tail = None
            else:
                del parent.children[leaf.tokens]
            self._alloc.decref(leaf.block)
            self.blocks_cached -= 1
            released += 1
        return released

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0
