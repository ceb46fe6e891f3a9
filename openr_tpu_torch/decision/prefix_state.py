"""PrefixState: prefix → {(node, area) → PrefixEntry} map
(reference: openr/decision/PrefixState.{h,cpp}).

update/delete return the set of prefixes whose candidate set changed, which
Decision uses to drive incremental rebuilds.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

from openr_tpu_torch.types import PrefixEntry

NodeAndArea = Tuple[str, str]


class PrefixState:
    def __init__(self) -> None:
        self._prefixes: Dict[str, Dict[NodeAndArea, PrefixEntry]] = {}

    def prefixes(self) -> Dict[str, Dict[NodeAndArea, PrefixEntry]]:
        return self._prefixes

    def get_received_routes_count(self) -> int:
        return sum(len(m) for m in self._prefixes.values())

    def update_prefix(
        self, node: str, area: str, entry: PrefixEntry
    ) -> Set[str]:
        """Insert/replace one advertisement; returns changed prefixes
        (PrefixState::updatePrefix, PrefixState.cpp)."""
        if self.update_prefix_changed(node, area, entry):
            return {entry.prefix}
        return set()

    def update_prefix_changed(
        self, node: str, area: str, entry: PrefixEntry
    ) -> bool:
        """update_prefix without the per-call set allocation — the bulk
        ingest path calls this half a million times on cold boot."""
        key: NodeAndArea = (node, area)
        entries = self._prefixes.setdefault(entry.prefix, {})
        prior = entries.get(key)
        if prior == entry:
            return False
        entries[key] = entry
        return True

    def delete_prefix(self, node: str, area: str, prefix: str) -> Set[str]:
        """Remove one advertisement; returns changed prefixes."""
        key: NodeAndArea = (node, area)
        entries = self._prefixes.get(prefix)
        if entries is None or key not in entries:
            return set()
        del entries[key]
        if not entries:
            del self._prefixes[prefix]
        return {prefix}

    def delete_all_for_node(self, node: str, area: str) -> Set[str]:
        """Drop every advertisement from (node, area) — node left the area."""
        changed: Set[str] = set()
        for prefix in list(self._prefixes):
            changed |= self.delete_prefix(node, area, prefix)
        return changed

    def has_prefix(self, prefix: str) -> bool:
        return prefix in self._prefixes
