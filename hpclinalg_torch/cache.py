"""Plan-cache registry with diagnostics.

The port keeps its own registry, separate from the JAX package's, so a
process that imports both never mixes their plans. Each named cache maps a
structural-hash key tuple to a built plan (host index metadata plus the
device tensors derived from it).
"""

from __future__ import annotations

from typing import Any, Callable, Hashable

_caches: dict[str, dict[Hashable, Any]] = {}


def plan_cache(name: str) -> dict:
    """Get (or create) the named plan cache."""
    return _caches.setdefault(name, {})


def cached_plan(name: str, key: Hashable, build: Callable[[], Any]) -> Any:
    """Memoized plan lookup."""
    c = plan_cache(name)
    hit = c.get(key)
    if hit is None:
        hit = build()
        c[key] = hit
    return hit


def cache_sizes() -> dict[str, int]:
    """Entry counts of every plan cache."""
    return {k: len(v) for k, v in sorted(_caches.items())}


def clear_plan_cache(name: str | None = None) -> None:
    """Drop all plans, or those of one named cache."""
    if name is None:
        for v in _caches.values():
            v.clear()
    else:
        _caches.get(name, {}).clear()


def check_cache_sizes(max_entries: int = 20) -> None:
    """Raise if any cache exceeds ``max_entries`` (a leak guard)."""
    offenders = {k: n for k, n in cache_sizes().items() if n > max_entries}
    if offenders:
        raise RuntimeError(f"plan caches exceed {max_entries} entries: {offenders}")
