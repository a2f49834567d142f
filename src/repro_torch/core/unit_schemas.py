"""Unit-size mapping-schema constructions (paper Sections 5-7).

Everything in this module works in the *unit-size world*: ``n`` abstract items
(in practice: bins produced by bin packing, treated as unit-size inputs) and an
integer reducer capacity ``k`` (number of items per reducer).  All functions
return ``list[list[int]]`` — reducer -> item ids in ``range(n)`` — plus, where
meaningful, the *team* structure the paper exploits (a team is a set of
reducers in which every item appears exactly once).

Implemented constructions:

  round_robin_teams   1-factorization of K_n (circle method) — the q=2
                      optimal schema of Section 5.1.  The paper's recursive
                      power-of-two construction yields the same object; the
                      circle method generalizes to every even n, which is the
                      "known techniques" generalization the paper alludes to.
  alg_even            Algorithm 2 (even k): group items into groups of k/2 and
                      take all pairs of groups via the team structure.
  alg_odd             Algorithm 1 (odd k >= 3): groups of (k-1)/2, pairs of
                      groups per reducer, one set-B item broadcast per team,
                      recursion on B.  k=3 reproduces Section 5.2 exactly.
  au_square           The AU method (Section 5.3): k prime, n = k^2,
                      k(k+1) reducers — meets the lower bound (optimal).
  au_projective       Extension: capacity k, k-1 prime, n = (k-1)^2 + k —
                      the projective-plane schema, optimal.
  alg3                First extension of the AU method (Section 7.1).
  alg4                Second extension (Section 7.2): n = k^l via the
                      bottom-up / assignment trees.
"""

from __future__ import annotations

import math
from typing import Optional

from .primes import is_prime, prev_prime

__all__ = [
    "round_robin_teams",
    "alg_even",
    "alg_odd",
    "au_square",
    "au_projective",
    "alg3",
    "alg4",
    "unit_lower_bound_reducers",
    "unit_lower_bound_comm",
]


# --------------------------------------------------------------------------
# lower bounds (Theorem 11, unit-size world)
# --------------------------------------------------------------------------
def unit_lower_bound_comm(n: int, k: int) -> int:
    """m * floor((m-1)/(q-1)) for unit inputs."""
    if n <= 1 or k <= 1:
        return n
    return n * ((n - 1) // (k - 1))


def unit_lower_bound_reducers(n: int, k: int) -> int:
    if n <= 1 or k <= 1:
        return 1
    return (n // k) * ((n - 1) // (k - 1))


# --------------------------------------------------------------------------
# q = 2: 1-factorization of K_n  (Section 5.1)
# --------------------------------------------------------------------------
def round_robin_teams(n: int) -> list[list[tuple[int, int]]]:
    """For even n: n-1 teams of n/2 disjoint pairs; every pair of items in
    range(n) appears in exactly one team (circle method)."""
    assert n % 2 == 0 and n >= 2, n
    others = list(range(1, n))
    teams = []
    for t in range(n - 1):
        rot = others[t:] + others[:t]
        pairs = [(0, rot[0])]
        for i in range(1, n // 2):
            pairs.append((rot[i], rot[n - 1 - i]))
        teams.append(pairs)
    return teams


# --------------------------------------------------------------------------
# Algorithm 2 — even capacity k  (Section 6)
# --------------------------------------------------------------------------
def alg_even(n: int, k: int, with_teams: bool = False):
    """All-pairs of n unit items with even reducer capacity k.

    Groups of k/2 items; every pair of groups shares one reducer.  Returns
    reducers (and optionally the team structure: team -> reducer ids)."""
    assert k >= 2 and k % 2 == 0
    if n <= 0:
        return ([], []) if with_teams else []
    if n <= k:
        reducers = [list(range(n))]
        return (reducers, [[0]]) if with_teams else reducers
    g = k // 2
    u = math.ceil(n / g)
    u_p = u + (u % 2)  # pad to even with empty groups
    groups = [list(range(i * g, min((i + 1) * g, n))) for i in range(u)]
    groups += [[] for _ in range(u_p - u)]
    reducers: list[list[int]] = []
    teams: list[list[int]] = []
    for pairs in round_robin_teams(u_p):
        team_rids = []
        for a, b in pairs:
            items = groups[a] + groups[b]
            if items:
                team_rids.append(len(reducers))
                reducers.append(items)
        teams.append(team_rids)
    return (reducers, teams) if with_teams else reducers


# --------------------------------------------------------------------------
# Algorithm 1 — odd capacity k >= 3  (Sections 5.2 and 6)
# --------------------------------------------------------------------------
def alg_odd(n: int, k: int) -> list[list[int]]:
    """All-pairs of n unit items with odd reducer capacity k >= 3.

    Pairs of (k-1)/2-item groups fill k-1 slots; the spare slot broadcasts one
    set-B item across a team; recurse on B.  k=3 is Section 5.2."""
    assert k >= 3 and k % 2 == 1
    if n <= 0:
        return []
    if n <= k:
        return [list(range(n))]
    g = (k - 1) // 2
    # smallest u with  u*g (set A) + (u_padded - 1) (set B) >= n
    u = max(2, math.ceil((n + 1) / (g + 1)))
    while u * g + (u + (u % 2)) - 1 < n:
        u += 1
    u_p = u + (u % 2)
    n_a = min(n, u * g)
    b_items = list(range(n_a, n))           # |B| <= u_p - 1
    assert len(b_items) <= u_p - 1
    groups = [list(range(i * g, min((i + 1) * g, n_a))) for i in range(u)]
    groups += [[] for _ in range(u_p - u)]
    reducers: list[list[int]] = []
    for t, pairs in enumerate(round_robin_teams(u_p)):
        extra = [b_items[t]] if t < len(b_items) else []
        for a, b in pairs:
            items = groups[a] + groups[b] + extra
            if items:
                reducers.append(items)
    # recurse for B x B pairs
    sub = alg_odd(len(b_items), k)
    for red in sub:
        reducers.append([b_items[i] for i in red])
    return reducers


# --------------------------------------------------------------------------
# AU method — k prime, n = k^2  (Section 5.3)
# --------------------------------------------------------------------------
def au_square(p: int, with_teams: bool = False):
    """Optimal schema for p^2 unit items, capacity p, p prime.

    Item (i, j) -> id i*p + j.  Team t in [0, p): reducer r holds cells with
    (i + t*j) mod p == r.  Team p: reducer r holds column r.  p+1 teams of p
    reducers; every team contains every item exactly once."""
    assert is_prime(p), p
    reducers: list[list[int]] = []
    teams: list[list[int]] = []
    for t in range(p):
        team_rids = []
        buckets: list[list[int]] = [[] for _ in range(p)]
        for i in range(p):
            for j in range(p):
                buckets[(i + t * j) % p].append(i * p + j)
        for r in range(p):
            team_rids.append(len(reducers))
            reducers.append(buckets[r])
        teams.append(team_rids)
    # column team
    team_rids = []
    for r in range(p):
        team_rids.append(len(reducers))
        reducers.append([i * p + r for i in range(p)])
    teams.append(team_rids)
    return (reducers, teams) if with_teams else reducers


def au_projective(p: int) -> list[list[int]]:
    """Optimal schema for n = p^2 + p + 1 items, capacity p + 1, p prime.

    AU square on the first p^2 items; new item p^2 + t joins every reducer of
    team t; one extra reducer holds all p + 1 new items."""
    assert is_prime(p), p
    base, teams = au_square(p, with_teams=True)
    reducers = [list(r) for r in base]
    new_ids = [p * p + t for t in range(p + 1)]
    for t, rids in enumerate(teams):
        for rid in rids:
            reducers[rid].append(new_ids[t])
    reducers.append(list(new_ids))
    return reducers


# --------------------------------------------------------------------------
# Algorithm 3 — first extension of the AU method  (Section 7.1)
# --------------------------------------------------------------------------
def alg3(n: int, k: int, p: Optional[int] = None) -> Optional[list[list[int]]]:
    """Capacity k, n items with p^2 < n <= p^2 + (k-p)(p+1), p prime <= k.

    AU square on A = first p^2 items (uses p of the k capacity); the k-p spare
    slots per reducer broadcast a group of B items per team; recursion on B.
    Returns None when no prime p <= k accommodates n."""
    if p is None:
        cand = k
        while cand >= 2:
            cand = prev_prime(cand)
            l = k - cand
            if n <= cand * cand + l * (cand + 1):
                p = cand
                break
            cand -= 1
        if p is None:
            return None
    l = k - p
    if n > p * p + l * (p + 1):
        return None
    # Pad A to p^2 with dummy ids >= n; caller-independent: we filter here.
    base, teams = au_square(p, with_teams=True)
    def real(ids):
        return [i for i in ids if i < n]
    reducers = [real(r) for r in base]
    b_items = list(range(p * p, n))  # x <= l*(p+1)
    # groups of <= l items, one group per team
    groups = [b_items[i * l:(i + 1) * l] for i in range(math.ceil(len(b_items) / max(l, 1)))] if l > 0 else []
    assert len(groups) <= p + 1
    for t, grp in enumerate(groups):
        for rid in teams[t]:
            reducers[rid].extend(grp)
    reducers = [r for r in reducers if r]
    # B x B pairs
    if len(b_items) > 1:
        sub = alg_odd(len(b_items), k) if k % 2 else alg_even(len(b_items), k)
        for red in sub:
            reducers.append([b_items[i] for i in red])
    return reducers


# --------------------------------------------------------------------------
# Algorithm 4 — second extension: n = k^l  (Section 7.2)
# --------------------------------------------------------------------------
def alg4(n: int, k: int) -> Optional[list[list[int]]]:
    """Capacity k prime, n = k^l (l >= 2): bottom-up tree + assignment tree.

    A *matrix* is a list of k^2 block ids, each block spanning ``size``
    consecutive items.  Applying the AU pattern to a matrix yields k(k+1)
    bins of k blocks; when size == 1 bins are reducers, otherwise each bin
    becomes a child matrix whose cells are the blocks' k children."""
    if not is_prime(k):
        return None
    l = round(math.log(n, k)) if n > 1 else 1
    if k ** l != n or l < 2:
        return None
    au = au_square(k)  # pattern over k^2 cell positions

    reducers: list[list[int]] = []

    def expand(matrix: list[int], size: int) -> None:
        # matrix: k^2 block ids at granularity `size`
        for bin_pos in au:
            blocks = [matrix[c] for c in bin_pos]
            if size == 1:
                reducers.append(blocks)
            else:
                child = []
                for b in blocks:
                    child.extend(b * k + j for j in range(k))
                expand(child, size // k)

    root_size = k ** (l - 2)
    expand(list(range(k * k)), root_size)
    return reducers
