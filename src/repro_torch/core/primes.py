"""Small prime utilities for the AU-method family of constructions."""

from __future__ import annotations

__all__ = ["is_prime", "prev_prime", "next_prime"]


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def prev_prime(n: int) -> int:
    """Largest prime <= n (raises for n < 2)."""
    if n < 2:
        raise ValueError("no prime <= 1")
    while not is_prime(n):
        n -= 1
    return n


def next_prime(n: int) -> int:
    """Smallest prime >= n."""
    n = max(n, 2)
    while not is_prime(n):
        n += 1
    return n
