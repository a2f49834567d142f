"""Lower bounds from the paper (Theorems 8, 9, 11, 25) and Table-1 upper
bounds, used by tests and the benchmark harness to validate the reproduction
against the paper's own claims.

``some_pairs_comm_lower_bound`` extends the replication-rate argument of
Afrati et al., "Upper and Lower Bounds on the Cost of a Map-Reduce
Computation", to an explicit required-pair set (Ullman & Ullman's some-pairs
problem).  The planner attaches the matching bound to every schema it
returns (``MappingSchema.lower_bound``) so plans self-report their
optimality gap.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "a2a_comm_lower_bound",
    "a2a_reducers_lower_bound",
    "a2a_binpack_comm_lower_bound",
    "a2a_unit_comm_lower_bound",
    "a2a_unit_reducers_lower_bound",
    "x2y_comm_lower_bound",
    "x2y_reducers_lower_bound",
    "some_pairs_comm_lower_bound",
    "a2a_k2_comm_upper_bound",
    "a2a_algk_comm_upper_bound",
    "x2y_comm_upper_bound",
    "big_input_comm_upper_bound",
]


def a2a_comm_lower_bound(weights, q: float) -> float:
    """Theorem 8: comm >= s^2 / q (valid when s >= q)."""
    s = float(np.sum(weights))
    return s * s / q if s >= q else s


def a2a_reducers_lower_bound(weights, q: float) -> float:
    """Theorem 8: reducers >= s^2 / q^2."""
    s = float(np.sum(weights))
    return max(1.0, s * s / (q * q))


def a2a_binpack_comm_lower_bound(weights, q: float, k: int) -> float:
    """Theorem 9: comm >= s * floor((sk/q - 1)/(k - 1)) for the bin-packing
    strategy with bins of size q/k."""
    s = float(np.sum(weights))
    x = s * k / q
    return s * np.floor((x - 1) / (k - 1)) if k > 1 else s


def a2a_unit_comm_lower_bound(m: int, q: int) -> int:
    """Theorem 11: m * floor((m-1)/(q-1)) for unit-size inputs."""
    return m * ((m - 1) // (q - 1)) if q > 1 else m

def a2a_unit_reducers_lower_bound(m: int, q: int) -> int:
    return (m // q) * ((m - 1) // (q - 1)) if q > 1 else 1


def x2y_comm_lower_bound(wx, wy, q: float) -> float:
    """Theorem 25: comm >= 2 * sum_x * sum_y / q."""
    sx, sy = float(np.sum(wx)), float(np.sum(wy))
    return 2.0 * sx * sy / q


def x2y_reducers_lower_bound(wx, wy, q: float) -> float:
    sx, sy = float(np.sum(wx)), float(np.sum(wy))
    return max(1.0, 2.0 * sx * sy / (q * q))


def some_pairs_comm_lower_bound(weights, q: float, pairs) -> float:
    """Replication-rate lower bound for an explicit required-pair set.

    Two arguments, take the max:

      * every input incident to >= 1 required pair ships at least once, so
        comm >= sum of incident weights;
      * a reducer holding inputs S with load L = sum_{i in S} w_i <= q
        covers pair products sum_{{i,j} in S} 2 w_i w_j <= L^2 <= q L.
        Summing over reducers, q * comm >= sum_{(i,j) in P} 2 w_i w_j,
        i.e. comm >= 2 * sum_P w_i w_j / q.  With P = all pairs this
        recovers Theorem 8 up to the diagonal term; with P = X x Y it is
        exactly Theorem 25.
    """
    w = np.asarray(weights, dtype=np.float64)
    p = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
    if p.size == 0:
        return 0.0
    incident = np.zeros(len(w), dtype=bool)
    incident[p.ravel()] = True
    lb_ship = float(np.sum(w[incident]))
    lb_pairs = 2.0 * float(np.sum(w[p[:, 0]] * w[p[:, 1]])) / q
    return max(lb_ship, lb_pairs)


# ------------------------------------------------------------------ upper
def a2a_k2_comm_upper_bound(weights, q: float) -> float:
    """Theorem 10 (k=2 bin packing): comm <= 4 s^2 / q."""
    s = float(np.sum(weights))
    return 4.0 * s * s / q


def a2a_algk_comm_upper_bound(weights, q: float, k: int) -> float:
    """Theorem 18 (Algorithms 1 and 2): comm <=
    (q / 2k) * ceil(sk/(q(k-1))) * (ceil(sk/(q(k-1))) - 1)."""
    s = float(np.sum(weights))
    g = np.ceil(s * k / (q * (k - 1)))
    return (q / (2.0 * k)) * g * (g - 1) if k > 1 else s


def x2y_comm_upper_bound(wx, wy, b: float) -> float:
    """Theorem 26: comm <= 4 sum_x sum_y / b for bin size b, q = 2b."""
    sx, sy = float(np.sum(wx)), float(np.sum(wy))
    return 4.0 * sx * sy / b


def big_input_comm_upper_bound(weights, q: float) -> float:
    """Theorem 24: comm <= (m-1) q + 4 s^2 / q when one input > q/2."""
    m = len(weights)
    s = float(np.sum(weights))
    return (m - 1) * q + 4.0 * s * s / q
