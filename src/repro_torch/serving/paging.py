"""Host-side bookkeeping for the PAGED KV cache (copy of
``repro.serving.paging``, kept in the port so it never imports the JAX
package).

The serving engine's paged mode keeps every request's KV in fixed-size
pages carved out of ONE pooled device buffer ``(n_layers, n_pages,
page_size, n_kv_heads, head_dim)``; which pages belong to which slot is
pure host state held here. Two pieces:

  - :class:`PagePool` — the free list plus per-page reference counts and
    frozen flags. A page is *frozen* once it enters the prefix trie:
    frozen pages are never placed in any write map, so sharing is
    copy-on-write by construction (a fork never needs to copy — it
    simply writes its divergent tail into its OWN pages and reads the
    shared ones).
  - :class:`PrefixTrie` — a radix trie over prompt-token pages, keyed by
    param VERSION at the root: KV is a function of (tokens, positions,
    params), so a page written under version ``v`` is only reusable by a
    request pinned to ``v``.

Everything here is deterministic: the free list is LIFO over a fixed
initial order, trie children are insertion-ordered dicts, and eviction
walks leaves in (last-use tick, page id) order — no set iteration, no
wall clock.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class PagePool:
    """Free list + refcounts + frozen flags over ``n_pages`` KV pages.

    Refcount protocol: ``alloc`` returns pages at refcount 1 (the owning
    slot). The prefix trie takes its OWN reference (``incref``) when a
    prompt page is published, and every later request that reuses the
    page increfs it too, so a page is freed exactly when its last reader
    — slot or trie — lets go. ``decref`` unfreezes on free, returning
    the page to the writable pool.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"PagePool needs n_pages>=1 and page_size>=1, "
                             f"got {n_pages}/{page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list seeded in reverse so pops come out 0, 1, 2, ...
        # — allocation order is deterministic and easy to eyeball
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.ref: List[int] = [0] * self.n_pages
        self.frozen: List[bool] = [False] * self.n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages (refcount 1 each), or None — all or nothing,
        so admission never half-allocates a request."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        return out

    def incref(self, page: int) -> None:
        if self.ref[page] < 1:
            raise ValueError(f"incref on free page {page}")
        self.ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        if self.ref[page] < 1:
            raise ValueError(f"decref on free page {page}")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.frozen[page] = False
            self._free.append(page)
            return True
        return False


class _TrieNode:
    __slots__ = ("children", "page", "tick")

    def __init__(self, page: int, tick: int):
        # child key: the NEXT page's tuple of page_size prompt tokens
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.page = page
        self.tick = tick


class PrefixTrie:
    """Radix trie over prompt pages, one root per param version.

    A node at depth ``j`` under root ``v`` holds the page storing KV for
    prompt tokens ``[j*page_size, (j+1)*page_size)`` computed under
    version ``v``; the path to it spells the full preceding prompt.
    Lookups match whole pages only and never the page containing a
    prompt's LAST token — the engine must prefill at least one real
    prompt token so the final chunk's logits yield the first sampled
    token (that cap is applied by the caller via ``max_pages``).
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._roots: Dict[int, Dict[Tuple[int, ...], _TrieNode]] = {}
        self._tick = 0  # logical LRU clock (monotone per lookup/insert)

    # -- introspection --------------------------------------------------
    @property
    def versions(self) -> List[int]:
        return sorted(self._roots)

    @property
    def n_pages_held(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    def _iter_nodes(self):
        for v in sorted(self._roots):
            stack = list(self._roots[v].values())
            while stack:
                node = stack.pop()
                yield node
                stack.extend(node.children.values())

    # -- core ops -------------------------------------------------------
    def _key(self, prompt: Sequence[int], j: int) -> Tuple[int, ...]:
        ps = self.page_size
        return tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])

    def lookup(self, version: int, prompt: Sequence[int],
               max_pages: int) -> List[int]:
        """Longest shared-prefix page run (<= ``max_pages`` pages) for
        ``prompt`` under ``version``. Touches every matched node's LRU
        tick; the caller must incref the returned pages before anything
        that might evict."""
        out: List[int] = []
        children = self._roots.get(int(version))
        for j in range(max_pages):
            if children is None:
                break
            node = children.get(self._key(prompt, j))
            if node is None:
                break
            self._tick += 1
            node.tick = self._tick
            out.append(node.page)
            children = node.children
        return out

    def insert(self, version: int, prompt: Sequence[int], j: int,
               page: int) -> bool:
        """Publish ``page`` as prompt page ``j`` of ``prompt`` under
        ``version``. Returns True when inserted (caller then increfs and
        freezes the page); False when the path already holds this prefix
        (a concurrent identical prompt published first — the caller's
        copy stays private) or the parent path is gone (evicted)."""
        children = self._roots.setdefault(int(version), {})
        for i in range(j):
            node = children.get(self._key(prompt, i))
            if node is None:
                return False
            children = node.children
        key = self._key(prompt, j)
        if key in children:
            return False
        self._tick += 1
        children[key] = _TrieNode(page, self._tick)
        return True

    # -- reclamation ----------------------------------------------------
    def evict_idle(self, pool: PagePool, n_needed: int) -> int:
        """Free up to ``n_needed`` pages by evicting IDLE leaves — trie
        nodes whose page has refcount 1 (the trie's own reference, no
        slot reading it) — oldest (tick, page) first. Interior nodes
        become evictable as their children go; returns pages freed."""
        freed = 0
        while freed < n_needed:
            best = None
            for v in sorted(self._roots):
                stack: List[Tuple[Dict, Tuple[int, ...], _TrieNode]] = [
                    (self._roots[v], k, nd)
                    for k, nd in self._roots[v].items()]
                while stack:
                    parent, key, node = stack.pop()
                    if not node.children and pool.ref[node.page] == 1:
                        cand = (node.tick, node.page, parent, key)
                        if best is None or cand[:2] < best[:2]:
                            best = cand
                    stack.extend((node.children, k, nd)
                                 for k, nd in node.children.items())
            if best is None:
                return freed
            _, page, parent, key = best
            del parent[key]
            pool.decref(page)
            freed += 1
        return freed

    def drop_version(self, version: int, pool: PagePool) -> int:
        """Release every page held under ``version`` (the version ring
        retired it — no slot can ever pin it again). Returns the number
        of trie references dropped."""
        root = self._roots.pop(int(version), None)
        if root is None:
            return 0
        dropped = 0
        stack = list(root.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            pool.decref(node.page)
            dropped += 1
        return dropped

    def drop_all(self, pool: PagePool) -> int:
        """Flush the whole prefix cache (every version)."""
        dropped = 0
        for v in list(sorted(self._roots)):
            dropped += self.drop_version(v, pool)
        return dropped
