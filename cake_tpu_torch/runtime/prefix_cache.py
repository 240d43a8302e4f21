"""Persistent cross-request prefix cache: a radix tree over page chains
(port of ``cake_tpu/runtime/prefix_cache.py``, pure Python).

Finished prompts leave their prefix KV pages behind as a radix tree keyed on
token-id chunks whose nodes own physical pages of the paged pool
(models/llama/paged_cache.py). A later request whose prompt shares that
prefix ``fork``s the chain into its lane's block table (refcounted, shared)
and prefills only the uncached suffix (runtime/serving.py admission +
models/llama/batch.paged_suffix_prefill): a shared system prompt is
prefilled once.

Alignment: the lockstep batch layout is LEFT-padded, so prompt token ``j``
of a lane with pad ``P`` lives at slot ``P + j``, in-page offset
``(P + j) % page_size``. KV values are pad-invariant (rope positions are
relative) but their packing into pages is not, so the cache keeps one tree
per alignment class ``pad % page_size``; across classes a prompt misses.

Each node owns ONE physical page and the token ids written into it (up to
``page_size``, or ``page_size - align`` for a class's depth-0 nodes). Nodes
hold one allocator reference per page; a fork adds the lane's own, so
eviction never frees a page a live lane maps. A PARTIAL node (the tail of an
inserted prompt) leaves a forking lane's fresh region mid-page: the engine
splits that page copy-on-write (``PageAllocator.make_private`` + a device
page copy) before any write lands.

The cache is bounded in pages: inserts evict least-recently-used unpinned
leaves (a node a live lane forked is pinned by its lease), and the engine
reclaims cold pages on demand before refusing work. The ``counters`` dict
and ``stats()`` carry the numbers the reference's records do: the
``cake_prefix_*`` counters and gauges (utils/metrics.py), ``prefix-hit``,
``-insert``, ``-evict`` and ``-clear`` flight events, and a ``prefix_pages``
counter track with ``prefix-hit``/``prefix-evict`` instants on the timeline.

One RLock guards every tree, LRU and pin mutation; the allocator is touched
only under it, from the engine thread.
"""

from __future__ import annotations

import itertools
import threading

from cake_tpu_torch.models.llama.paged_cache import PageAllocator
from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.utils import metrics

_C_HIT = "cake_prefix_hits_total"
_C_MISS = "cake_prefix_misses_total"
_C_TOK = "cake_prefix_hit_tokens_total"
_C_INS = "cake_prefix_inserts_total"
_C_EVICT = "cake_prefix_evictions_total"
_G_PAGES = "cake_prefix_pages"
_G_NODES = "cake_prefix_nodes"


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _Node:
    """One page chain link: a physical page + the token ids written into it."""

    __slots__ = ("page", "tokens", "span", "children", "parent", "last_used", "pins")

    def __init__(self, page: int, tokens: tuple, span: int, parent):
        self.page = page
        self.tokens = tokens
        self.span = span  # token capacity of this page (ps, or ps - align at depth 0)
        self.children: list[_Node] = []
        self.parent = parent
        self.last_used = 0
        self.pins = 0

    @property
    def full(self) -> bool:
        return len(self.tokens) == self.span


class _Root:
    """Per-alignment-class tree root (owns no page)."""

    __slots__ = ("children",)

    def __init__(self):
        self.children: list[_Node] = []


class PrefixLease:
    """A live lane's pin on the chain it forked: while held, the matched
    nodes cannot be evicted. Released when the lane's pages return to the
    pool; idempotent, and a no-op after ``clear()`` (generation check)."""

    __slots__ = ("_nodes", "_generation", "_released")

    def __init__(self, nodes: list[_Node], generation: int):
        self._nodes = nodes
        self._generation = generation
        self._released = False


class ForkPlan:
    """Result of a successful ``fork``: how much of the prompt the spliced
    chain serves, and whether the lane's fresh region starts mid-page (the
    engine must then ``make_private`` + copy that page before any write)."""

    __slots__ = ("served", "cow_logical", "lease")

    def __init__(self, served: int, cow_logical: int | None, lease: PrefixLease):
        self.served = served  # prompt tokens covered by forked pages
        self.cow_logical = cow_logical  # logical page needing a CoW split
        self.lease = lease


class PrefixCache:
    """Lock-owning, bounded, persistent prefix cache over the page pool."""

    def __init__(self, allocator: PageAllocator, *, max_pages: int, min_tokens: int = 0):
        if max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {max_pages}")
        self.allocator = allocator
        self.page_size = allocator.page_size
        self.max_pages = max_pages
        self.min_tokens = max(0, min_tokens)
        self._lock = threading.RLock()
        self._roots: dict[int, _Root] = {}
        self._pages_held = 0
        self._n_nodes = 0
        self._generation = 0
        self._tick = itertools.count(1)
        self.counters = {
            "hits": 0, "misses": 0, "hit_tokens": 0,
            "inserts": 0, "evictions": 0, "clears": 0,
        }

    # ------------------------------------------------------------- internals

    def _span0(self, align: int) -> int:
        """Token capacity of a class's depth-0 page (it also holds the
        sub-pad region below the alignment offset)."""
        return self.page_size - align

    def _best_child(self, node, ids, offset: int, span: int):
        """The child sharing the longest token prefix with ``ids[offset:]``
        over this span (siblings may share leading tokens, so scan)."""
        best, best_m = None, 0
        chunk = ids[offset : offset + span]
        for c in node.children:
            m = _common_prefix(c.tokens, chunk)
            if m > best_m:
                best, best_m = c, m
        return best, best_m

    def _bump(self, nodes: list[_Node]) -> None:
        t = next(self._tick)
        for n in nodes:
            n.last_used = t

    def _iter_nodes(self):
        stack = [c for r in self._roots.values() for c in r.children]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children)

    def _walk(self, root, ids: list[int], align: int) -> tuple[int, list[_Node]]:
        """The longest chain serving ``ids`` under ``root``: (served tokens,
        matched nodes), capped at ``len(ids) - 1`` (the last prompt token is
        always recomputed so the epoch has a hidden state to sample from)."""
        matched: list[_Node] = []
        served, offset, span = 0, 0, self._span0(align)
        cap = len(ids) - 1
        cur = root
        while cur is not None and served < cap:
            c, m = self._best_child(cur, ids, offset, span)
            if c is None or m == 0:
                break
            take = min(m, cap - served)
            matched.append(c)
            served += take
            if take < span or m < len(c.tokens) or not c.full:
                break  # partial page coverage: the chain ends mid-page
            offset += span
            cur = c
            span = self.page_size
        return served, matched

    # ------------------------------------------------------------------ read

    def match_tokens(self, ids: list[int], align: int) -> int:
        """Advisory served-prefix length for admission pricing: how many
        tokens a ``fork`` at this alignment would cover now. Read-only."""
        with self._lock:
            root = self._roots.get(align % self.page_size)
            if root is None or len(ids) < 2:
                return 0
            served, _ = self._walk(root, ids, align % self.page_size)
            return served if served >= max(self.min_tokens, 1) else 0

    def radix_key(self, ids: list[int], align: int) -> tuple | None:
        """Grouping key for cache-aware admission ordering: requests whose
        prompts extend the same first radix node at this alignment share a
        key; a miss is None. Read-only, valid within one decision."""
        with self._lock:
            align %= self.page_size
            root = self._roots.get(align)
            if root is None or len(ids) < 2:
                return None
            c, m = self._best_child(root, ids, 0, self._span0(align))
            if c is None or m == 0:
                return None
            return (align, id(c))

    def reclaimable(self) -> int:
        """Pages eviction could free RIGHT NOW: nodes of unpinned subtrees
        whose page has no reference besides the cache's own. A restore's
        page check counts them as available (runtime/serving.py)."""
        with self._lock:
            total = 0

            def walk(node) -> bool:
                nonlocal total
                free_sub = node.pins == 0
                for c in node.children:
                    free_sub &= walk(c)
                if free_sub and self.allocator.refcount[node.page] == 1:
                    total += 1
                return free_sub

            for root in self._roots.values():
                for c in root.children:
                    walk(c)
            return total

    def stats(self) -> dict:
        with self._lock:
            return {
                "pages": self._pages_held,
                "max_pages": self.max_pages,
                "nodes": self._n_nodes,
                "alignment_classes": len(self._roots),
                **self.counters,
            }

    # ------------------------------------------------------------------ fork

    def _update_gauges(self) -> None:
        metrics.registry.gauge(_G_PAGES, "KV pages held by the persistent prefix cache.").set(
            self._pages_held)
        metrics.registry.gauge(_G_NODES, "Prefix-cache radix nodes (one page each).").set(
            self._n_nodes)
        timeline.counter("prefix_pages", {"held": float(self._pages_held),
                                          "shared": float(self.allocator.pages_shared)},
                         track="prefix")

    def fork(self, lane: int, ids: list[int], pad: int, rid: str = "") -> ForkPlan | None:
        """Splice the longest cached chain matching ``ids`` into ``lane``'s
        block table (shared pages, +1 ref each) and pin it. None on a miss
        (nothing mapped). On a hit the suffix prefill starts at slot
        ``pad + served``; when that lands mid-page, ``cow_logical`` names
        the shared page to split before the first divergent write."""
        align = pad % self.page_size
        with self._lock:
            served, matched = self._walk(self._roots.get(align), ids, align)
            if served < max(self.min_tokens, 1):
                self.counters["misses"] += 1
                metrics.registry.counter(
                    _C_MISS, "Prompt admissions with no usable cached prefix.").inc()
                return None
            first_logical = pad // self.page_size
            self.allocator.fork_chain(lane, [n.page for n in matched], first_logical)
            cow = (align + served) % self.page_size != 0
            cow_logical = first_logical + len(matched) - 1 if cow else None
            for n in matched:
                n.pins += 1
            self._bump(matched)
            self.counters["hits"] += 1
            self.counters["hit_tokens"] += served
            metrics.registry.counter(_C_HIT, "Prompt admissions served a cached prefix chain.").inc()
            metrics.registry.counter(_C_TOK, "Prompt tokens served from cached prefix pages.").inc(
                served)
            metrics.flight.record("prefix-hit", rid, lane=lane, tokens=served,
                                  pages=len(matched), cow=bool(cow))
            timeline.instant("prefix-hit", rid=rid, track="prefix",
                             args={"tokens": served, "pages": len(matched)})
            self._update_gauges()
            return ForkPlan(served, cow_logical, PrefixLease(matched, self._generation))

    def release(self, lease: PrefixLease | None) -> None:
        """Unpin a fork's chain (the lane released its pages)."""
        if lease is None:
            return
        with self._lock:
            if lease._released or lease._generation != self._generation:
                return
            lease._released = True
            for n in lease._nodes:
                n.pins -= 1

    # ---------------------------------------------------------------- insert

    def insert(self, lane: int, ids: list[int], pad: int, rid: str = "") -> int:
        """Adopt a finished lane's prompt-prefix pages into the tree
        (zero-copy: +1 cache reference per newly adopted page; pages already
        cached refresh their LRU stamp). Returns pages newly retained. A
        later insert covering MORE of a partial node's span swaps in its
        page (forks of the old page keep it alive by refcount)."""
        align = pad % self.page_size
        if len(ids) < max(self.min_tokens, 2):
            return 0
        with self._lock:
            root = self._roots.setdefault(align, _Root())
            adopted = 0
            offset, span = 0, self._span0(align)
            logical = pad // self.page_size
            cur: _Root | _Node = root
            path: list[_Node] = []
            while offset < len(ids):
                chunk = tuple(ids[offset : offset + span])
                phys = int(self.allocator.block_tables[lane][logical])
                if phys < 0:
                    break  # the lane holds no storage here
                c, m = self._best_child(cur, ids, offset, span)
                if c is not None and m == len(chunk) and len(c.tokens) >= m:
                    path.append(c)  # already covered (maybe by a longer partial)
                    if len(chunk) < span or not c.full:
                        break
                elif c is not None and m == len(c.tokens) and not c.full and len(chunk) > m:
                    # Extend a partial node with the lane's fuller page.
                    self.allocator.retain_pages([phys])
                    self.allocator.release_pages([c.page])
                    c.page = phys
                    c.tokens = chunk
                    path.append(c)
                    adopted += 1
                    if not c.full:
                        break
                else:
                    # New branch (empty span, or divergence mid-span: the new
                    # chain lands as a sibling).
                    self.allocator.retain_pages([phys])
                    node = _Node(phys, chunk, span, cur if isinstance(cur, _Node) else None)
                    cur.children.append(node)
                    self._n_nodes += 1
                    self._pages_held += 1
                    path.append(node)
                    adopted += 1
                    if not node.full:
                        break
                cur = path[-1]
                offset += span
                logical += 1
                span = self.page_size
            if not path:
                return 0
            self._bump(path)
            self.counters["inserts"] += 1
            metrics.registry.counter(
                _C_INS, "Prompt-prefix chains inserted/refreshed on finish.").inc()
            metrics.flight.record("prefix-insert", rid, lane=lane, pages=adopted,
                                  chain_pages=len(path))
            self._evict_to_budget()
            self._update_gauges()
            return adopted

    # -------------------------------------------------------------- eviction

    def _evictable_leaves(self) -> list[_Node]:
        return [n for n in self._iter_nodes() if not n.children and n.pins == 0]

    def _evict_one(self, node: _Node) -> int:
        """Drop one unpinned leaf; returns pages actually FREED (0 when a
        lane still maps the page)."""
        with self._lock:
            if node.parent is not None:
                siblings = node.parent.children
            else:
                siblings = next(r.children for r in self._roots.values() if node in r.children)
            siblings.remove(node)
            free0 = self.allocator.pages_free
            self.allocator.release_pages([node.page])
            self._n_nodes -= 1
            self._pages_held -= 1
            self.counters["evictions"] += 1
            metrics.registry.counter(
                _C_EVICT, "Prefix-cache nodes evicted (LRU or on-demand).").inc()
            return self.allocator.pages_free - free0

    def _evict_to_budget(self) -> None:
        while self._pages_held > self.max_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                return  # everything pinned: live lanes hold the budget
            self._evict_one(min(leaves, key=lambda n: n.last_used))

    def reclaim(self, n_pages: int, rid: str = "") -> int:
        """Evict LRU-first until ``n_pages`` pages actually reach the free
        list (or nothing evictable remains). Returns pages freed."""
        if n_pages <= 0:
            return 0
        with self._lock:
            freed = 0
            while freed < n_pages:
                leaves = self._evictable_leaves()
                if not leaves:
                    break
                freed += self._evict_one(min(leaves, key=lambda n: n.last_used))
            if freed:
                metrics.flight.record("prefix-evict", rid, pages=freed, wanted=n_pages)
                timeline.instant("prefix-evict", track="prefix", args={"pages": freed})
            self._update_gauges()
            return freed

    def clear(self, reason: str = "") -> int:
        """Drop every chain (pool rebuild, failed epoch, tests). Pages still
        mapped by live lanes survive through their lane refs. Outstanding
        leases die with the generation. Returns pages freed."""
        with self._lock:
            free0 = self.allocator.pages_free
            pages = [n.page for n in self._iter_nodes()]
            if pages:
                self.allocator.release_pages(pages)
            self._roots = {}
            self._pages_held = 0
            self._n_nodes = 0
            self._generation += 1
            self.counters["clears"] += 1
            freed = self.allocator.pages_free - free0
            if pages:
                metrics.flight.record("prefix-clear", pages=len(pages), freed=freed, reason=reason)
            self._update_gauges()
            return freed
